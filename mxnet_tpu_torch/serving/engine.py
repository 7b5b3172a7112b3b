"""Continuous-batching serving engine over a slot-paged KV cache.

Counterpart of the core of ``mxnet_tpu/serving/engine.py``
``InferenceEngine`` (l.434): ``S`` cache slots, each holding one sequence
at its own position. A round advances one piece of the oldest request
still being prefilled in pieces, admits queued requests into free slots —
a prefix-cache lookup (the longest retained prompt prefix, copied into
the slot), then the first prefill piece of the uncovered suffix, right-
padded to the smallest bucket that holds it, its first token picked at
the last real position (l.1576-1646, l.2460-2740) — then runs one decode
round over all slots at once: ``steps_per_round`` plain decode steps
(l.1427-1491), or with speculation one verify step that scores each
slot's drafted tokens and emits its accepted prefix (l.1493, l.2895) —
and drains token vectors ``drain_depth`` rounds behind (eagerly under
speculation), so the host schedules the next round while the card works.
Requests retire on EOS or their length budget; a full queue refuses
``submit`` (``max_queue`` backpressure).

As in the JAX package, every request mix runs through a fixed set of
compiled programs (``parallel.program.Program``: CUDA graphs on the card,
the same functions over the same buffers on the CPU): ONE decode program
for a whole round (tag ``"decode"``), one prefill program per used bucket
(``("prefill", bucket)``) for whole prompts and every chunk piece alike,
one prefix-copy program per used bucket (``("copy", bucket)``) for both
directions (pool -> slot on a hit, slot -> pool on retention), ONE verify
program (``"verify"``) and, with a draft model, ONE proposal program
(``"draft"``) and one draft-prefill program per used bucket
(``("draft_prefill", bucket)``). Slots, lengths, chunk starts, copy
sources and destinations, drafts and their lengths are device operands,
so no request mix adds a program; ``compile_counts`` reports them in the
JAX shape, and no switch turns capture off. The slot cache, the prefix
pool, the per-slot state vectors and the programs' operand buffers keep
their addresses for the life of the engine: the programs update them in
place. The pool is the tail of the same cache buffers (``[S + P, ...]``,
the serving cache their view ``[:S]``), so one copy program moves rows
between any two slots without a branch; and every buffer of one dtype
and row shape is a view of one allocation, so that a copy between slots
(a prefix copy, a prefill piece's gather-in and write-back) is one kernel
an allocation, not one a buffer.

Greedy decoding is deterministic, and speculation and the prefix cache
change no token. Sampled decoding draws on the device with
``parallel.decode.sample_tokens``, a pure function of the request's
``seed`` and the token's position (the counterpart of the JAX package's
``fold_in(seed, position)``), so a request's stream does not depend on
what else is scheduled, nor on whether speculation is on (it cannot
equal the JAX package's draws).

Robustness and observability (the JAX package's l.70-82), all host-side:
the programs above are the ONLY device programs. Prompts are staged
host -> device up to ``stage_depth`` requests ahead of admission;
per-request deadlines (``deadline_ms``/``ttft_deadline_ms``) and
:meth:`~InferenceEngine.cancel` retire work at round boundaries through
the same dead-slot freeze and slot recycling normal retirement uses;
``overload`` policies shed load with a typed :class:`EngineOverloaded`;
a round watchdog (``round_timeout_ms``) polls a CUDA event recorded after
each dispatch and turns a wedged round into a typed, recoverable
:class:`EngineStuck`; per-request host failures poison only their own
request; :meth:`~InferenceEngine.snapshot` /
:meth:`~InferenceEngine.restore` rebuild the scheduler after a crash with
byte-identical greedy continuations (the snapshot is the JAX package's
version-1 JSON, and restores onto either package's engine; a restored
request regenerates its emitted tokens where the JAX engine prefills
them: :class:`Request` says why);
:meth:`~InferenceEngine.close` fails everything pending with
:class:`EngineClosed`, frees the engine's device memory and is
idempotent. The ``serving.*`` metrics (``mxnet_tpu_torch.telemetry``), a
per-round phase ledger (:meth:`~InferenceEngine.round_table`), SLO burn
gauges and a per-request flight recorder (:class:`.flight.FlightRecorder`)
say what the engine did.

Traffic capture (``capture_dir``, :mod:`.capture`) records every
accepted submit and its retirement for ``python -m
mxnet_tpu_torch.serving.replay``. Role-specialized engines (``role=
"prefill"``/``"decode"``, the JAX package's l.1035-1066) split a request
across two engines: a prefill engine runs admission and prefill only and
packages each finished prefill as a :class:`~.handoff.KVHandoff`; a decode
engine admits packages only (:meth:`~InferenceEngine.admit_handoff`),
never a prompt. The rows move through one more program family, the
per-bucket handoff row movers (``("handoff", bucket)``: export gathers a
slot's rows into a fixed staging buffer that is then copied out; import
copies rows into it and writes them into a slot). The
:class:`~.fleet.FleetRouter` drives the handoffs between engines.

The attention read is the decoder's (``attn_impl``, the JAX package's
l.977-1124): the paged kernel, or the dense read (blocked for the decode
steps where the decoder has a ``cache_block``; the JAX engine serves
``cache_block=None`` only). A windowed decoder's rings are served by its
dense ring read: without a prefix pool, without speculation (asked for, it
warns and turns it off) and as a unified engine only; a prefill piece wipes
the slot's ring positions on the request's first piece and writes only its
real rows into the ring, and the staging cache carries each ring and its
positions whole (a ring row is not addressed by absolute position).

Tensor-parallel serving (``tp``/``mesh``, the JAX package's l.790-951):
the KV cache — the slot cache, the prefix pool, the staging caches, the
draft model's and the handoff staging buffers — is sharded over the
mesh's ``model`` axis on its kv heads, one set of allocations a rank
(``Decoder.init_cache(kv_sharding=)``), and every program family runs the
walk with ``tp``: the position-wise ops once at tp=1's shapes, each
attention node per rank on its shard with one all-gather of the heads.
The program families and their counts are tp=1's; a copy between slots
is one kernel an allocation of every rank. The mesh is single-controller
and its ranks all name the engine's device (``[cuda:0] * 2`` on one card,
``["cpu"] * 2`` on the host): each program is still one CUDA graph, and a
mesh over distinct cards belongs to a later slice. Expert parallelism
(``ep``, the JAX package's l.815-940) composes with it on a mesh with an
``expert`` axis: each MoE node's gate and expert stacks are held as ``ep``
rank shards, one allocation a rank, and the prefill, decode and verify
programs run the walk with ``ep`` (each rank routes on the all-gathered
gate row, computes its own experts, and a second all-gather puts their
weighted outputs back in expert order for ep=1's reduction). The KV cache
does not depend on ``ep``.
"""
from __future__ import annotations

import collections
import functools
import itertools
import math
import os
import time
import warnings
import weakref

import numpy as np
import torch

from .. import telemetry as tele
from ..base import MXNetError, later_slice
from ..io import StagedStream
from ..ops.attention import MultiHeadAttention as _MHA
from ..parallel.decode import (CACHE_FILL, Decoder, rank_trees, ring_entry,
                               sample_tokens, uniform_draw)
from ..parallel.mesh import Mesh, build_mesh, model_parallel_mesh
from ..parallel.program import Program, copy_in
from ..parallel.shard import NamedSharding, PartitionSpec
from .capture import CaptureStream
from .flight import FlightRecorder
from .handoff import HANDOFF_DTYPES, KVHandoff, unpack_rows
from .prefix import PrefixCache
from .quant import (QuantizedTensor, quantize_params, quantized_weight_names,
                    weight_nbytes)
from .spec import NgramDrafter

__all__ = ["InferenceEngine", "Request", "EngineOverloaded",
           "EngineClosed", "EngineStuck"]

# monotonic suffix for auto-assigned engine ids ("e<pid>.<n>"): ids are
# unique within a process across engine rebuilds (a restore() successor
# gets a FRESH id; the donor's travels in ``migrated_from``)
_ENGINE_SEQ = itertools.count()

# live engines, for the exposition server (telemetry_http); weak, so that
# telemetry never keeps an engine the caller dropped alive
_ENGINES = weakref.WeakSet()

# serving-side fault injection (mxnet_tpu_torch.testing.faults): an
# installed injector's hooks run at the engine's host-side seams —
# admission staging, post-dispatch (simulated crash), and the watchdog's
# readiness poll. None in production; never on a device path.
_SERVING_FAULTS = None


class EngineOverloaded(MXNetError):
    """Typed overload signal: raised by ``submit`` under the ``shed``
    policy when the queue is full (and attached as the ``error`` of
    requests evicted by ``shed_oldest``). Callers fail fast and retry
    against another replica instead of queueing into a missed SLO."""


class EngineClosed(MXNetError):
    """The engine was shut down: raised by ``submit``/``step`` after
    :meth:`InferenceEngine.close`, and attached as the ``error`` of
    requests that were still pending when close ran."""


class EngineStuck(MXNetError):
    """Round watchdog trip: a dispatched device round failed to
    materialize within ``round_timeout_ms``. The undrained round stays
    queued — a later ``step()`` retries it if the device recovers;
    otherwise ``snapshot()`` still works (host state only) and
    ``restore()`` resumes every request on a fresh engine."""


# hard bound on reserved prefix-pool slots (the JAX package's): the byte
# budget is the real knob; this only stops a tiny model and a big budget
# from minting a silly slot axis
_MAX_POOL_SLOTS = 256

# the JAX package's serving.* metric set (its l.158-306), all host-side
# perf_counter arithmetic on values the scheduler already tracks: nothing
# new crosses the device boundary
_TM_QUEUE_WAIT_MS = tele.histogram("serving.queue_wait_ms")
_TM_TTFT_MS = tele.histogram("serving.ttft_ms")
_TM_CADENCE_MS = tele.histogram("serving.token_cadence_ms")
_TM_TOKENS = tele.counter("serving.tokens")
_TM_COMPLETED = tele.counter("serving.completed")
_TM_RETIRED_EOS = tele.counter("serving.retired_eos")
_TM_RETIRED_LENGTH = tele.counter("serving.retired_length")
_TM_ROUNDS = tele.counter("serving.rounds")
_TM_PREFILLS = tele.counter("serving.prefills")
_TM_ADMITTED = tele.histogram(
    "serving.admitted_per_round", buckets=(0, 1, 2, 4, 8, 16, 32, 64))
_TM_SLOTS_BUSY = tele.histogram(
    "serving.slots_busy_per_round",
    buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128))
_TM_OCCUPANCY = tele.gauge("serving.slot_occupancy")
# info gauges, set at construction (engine-last-built semantics): the
# attention impl (1 = paged), the tensor-parallel degree and each shard's
# slot-cache KV bytes, the weight dtype (0 float, 1 int8,
# 2 int4), the engine's stored weight bytes (the draft model's included),
# the matmul impl (0 dense, 1 pallas, 2 fused) and the int4 group width
_TM_ATTN_IMPL = tele.gauge("serving.attn_impl")
_TM_TP = tele.gauge("serving.tp_degree")
_TM_TP_KV_BYTES = tele.gauge("serving.kv_bytes_per_shard")
_TM_WEIGHT_DTYPE = tele.gauge("serving.weight_dtype")
_TM_WEIGHT_BYTES = tele.gauge("serving.weight_bytes")
_TM_MATMUL_IMPL = tele.gauge("serving.matmul_impl")
_TM_WEIGHT_GROUP = tele.gauge("serving.weight_group_size")
# prefix cache and chunked prefill
_TM_PREFIX_HITS = tele.counter("serving.prefix_hits")
_TM_PREFIX_MISSES = tele.counter("serving.prefix_misses")
_TM_PREFIX_HIT_TOKENS = tele.counter("serving.prefix_hit_tokens")
_TM_PREFIX_LOOKUP_MS = tele.histogram(
    "serving.prefix_lookup_ms",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0))
_TM_PREFIX_BYTES = tele.gauge("serving.prefix_cache_bytes")
_TM_PREFIX_EVICTIONS = tele.counter("serving.prefix_evictions")
_TM_PREFIX_INSERT_SKIPPED = tele.counter(
    "serving.prefix_insert_skipped")
_TM_CHUNKS = tele.histogram(
    "serving.prefill_chunks_per_request",
    buckets=(1, 2, 4, 8, 16, 32, 64))
# speculative decoding: drafted against accepted tokens, the accepted
# length a drafting slot, drafter mix, rounds that fell back to decode
_TM_SPEC_ROUNDS = tele.counter("serving.spec_rounds")
_TM_SPEC_FALLBACK = tele.counter("serving.spec_fallback_rounds")
_TM_SPEC_DRAFTED = tele.counter("serving.spec_drafted_tokens")
_TM_SPEC_ACCEPTED = tele.counter("serving.spec_accepted_tokens")
_TM_SPEC_ACCEPT_LEN = tele.histogram(
    "serving.spec_accepted_per_step",
    buckets=(0, 1, 2, 3, 4, 6, 8, 12, 16))
_TM_SPEC_NGRAM = tele.counter("serving.spec_drafts_ngram")
_TM_SPEC_MODEL = tele.counter("serving.spec_drafts_model")
# compile_counts as telemetry, one count a program build (a capture on
# the card)
_TM_COMPILES = {
    "decode": tele.counter("serving.compiles_decode"),
    "prefill": tele.counter("serving.compiles_prefill"),
    "copy": tele.counter("serving.compiles_copy"),
    "verify": tele.counter("serving.compiles_verify"),
    "draft": tele.counter("serving.compiles_draft"),
    "draft_prefill": tele.counter("serving.compiles_draft"),
    "handoff": tele.counter("serving.compiles_handoff")}
# disaggregated prefill/decode: the engine's role (0 unified, 1 prefill,
# 2 decode; engine-last-built semantics) and how long a finished prefill
# waited from packaging to its admission on a decode engine (observed by
# the fleet router at delivery)
_TM_ROLE = tele.gauge("serving.role")
_TM_HANDOFF_WAIT = tele.histogram("serving.handoff_wait_ms")
# robustness: every abnormal retirement path
_TM_SHED = tele.counter("serving.shed")
_TM_DEADLINE = tele.counter("serving.deadline_missed")
_TM_CANCELLED = tele.counter("serving.cancelled")
_TM_ERRORS = tele.counter("serving.request_errors")
_TM_WATCHDOG = tele.counter("serving.watchdog_trips")
_TM_RESTORES = tele.counter("serving.restores")
# SLO accounting: attainment counters tick where the TTFT and cadence
# histograms are fed; the burn gauges are multi-window derivatives of
# those histograms (tele.SloWindow), refreshed each round
_TM_SLO_TTFT_OK = tele.counter("serving.slo_ttft_attained")
_TM_SLO_TTFT_MISS = tele.counter("serving.slo_ttft_missed")
_TM_SLO_CAD_OK = tele.counter("serving.slo_cadence_attained")
_TM_SLO_CAD_MISS = tele.counter("serving.slo_cadence_missed")
_SLO_TTFT_WINDOWS = (
    (60.0, tele.gauge("serving.slo_ttft_burn_1m")),
    (300.0, tele.gauge("serving.slo_ttft_burn_5m")),
    (3600.0, tele.gauge("serving.slo_ttft_burn_1h")))
_SLO_CADENCE_WINDOWS = (
    (60.0, tele.gauge("serving.slo_cadence_burn_1m")),
    (300.0, tele.gauge("serving.slo_cadence_burn_5m")),
    (3600.0, tele.gauge("serving.slo_cadence_burn_1h")))
# round-phase attribution: where one step()'s wall time went. Every
# phase is a same-thread perf_counter interval the step already
# brackets; "sched" is the unattributed remainder (host scheduling), so
# the phases SUM to the round's wall time by construction
_PHASE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                  25.0, 50.0, 100.0, 500.0, 5000.0)
_TM_PHASE = {k: tele.histogram("serving.round_phase_ms." + k,
                               buckets=_PHASE_BUCKETS)
             for k in ("sched", "prefix_lookup", "h2d", "prefill", "copy",
                       "dispatch", "drain")}
_TM_ROUND_WALL = tele.histogram("serving.round_wall_ms",
                                buckets=_PHASE_BUCKETS)
# bounded per-engine ledger of recent rounds: the histograms above are
# the fleet view, the ledger is the incident view
_ROUND_LEDGER = 256


class Request:
    """One submitted generation request (the handle ``submit`` returns).

    ``tokens`` fills in as output drains (generated ids only, including
    ``eos_id`` when hit); ``done`` flips when the sequence retires;
    ``result()`` returns the tokens as int32 numpy. ``retire_reason`` once
    done is ``"eos"`` / ``"length"`` (normal completion), ``"deadline"`` /
    ``"cancelled"`` (host-retired, ``result()`` returns the tokens
    generated so far), or ``"shed"`` / ``"error"`` / ``"closed"`` (failed:
    ``result()`` raises the typed ``error``; partial tokens stay readable
    on ``.tokens``). ``t_submit``/``t_admit``/``t_first``/``t_done`` are
    ``time.perf_counter`` seconds (first = first token drained, i.e.
    visible to the caller). ``prefix_hit_tokens`` counts the prompt
    positions whose K/V came from the prefix cache instead of a prefill;
    ``prefill_chunks`` the prefill pieces that admitted the prompt (1
    unless ``prefill_chunk`` split it). ``resume_tokens`` are tokens a
    crashed engine already emitted (``restore()``; ``seq`` = prompt +
    those): the engine prefills the prompt and regenerates them through
    its own decode and verify rounds — each checked against the recorded
    token and not emitted again — before it emits new ones. A prefill
    writes a position's K/V with other rounding than the decode step that
    first wrote it (the chunk read and the products at another M), so
    re-prefilling ``seq``, as the JAX package does, would not give the
    uninterrupted run's rows; the rounds' kernels are batch-invariant
    and give them bit for bit. Should a regenerated token differ (a
    snapshot from another package or configuration), the request is
    prefilled again over ``seq``, the JAX package's way.

    A KV handoff carries the same distinction across engines: a resumed
    request on a prefill-role engine prefills its prompt, checks its first
    recorded token, and hands the rest to the decode engine to regenerate
    (:meth:`InferenceEngine.admit_handoff`)."""

    def __init__(self, rid, prompt, max_tokens, eos_id, temperature, seed,
                 limit, deadline_ms=None, ttft_deadline_ms=None,
                 resume_tokens=()):
        self.id = rid
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.eos_id = eos_id
        self.temperature = temperature
        self.seed = seed
        self.limit = limit          # min(max_tokens, max_len - P)
        self.tokens = list(int(t) for t in resume_tokens)
        self.resumed = len(self.tokens)
        self.seq = prompt if not self.resumed else np.concatenate(
            [prompt, np.asarray(self.tokens, prompt.dtype)])
        self._replay = self.resumed     # emitted tokens not regenerated yet
        self._prefilled = 0             # positions the final prefill covered
        # fleet trace context: (trace_id, hop) when a FleetRouter placed
        # the request (``submit(_trace=)``, a handoff's admission)
        self.trace = None
        self.done = False
        self.error = None
        self.t_submit = time.perf_counter()
        self.t_admit = None
        self.t_first = None
        self.t_done = None
        self.retire_reason = None
        self.prefix_hit_tokens = 0
        self.prefill_chunks = 0
        self.deadline_ms = deadline_ms
        self.ttft_deadline_ms = ttft_deadline_ms
        self._deadline = None if deadline_ms is None \
            else self.t_submit + deadline_ms / 1e3
        self._ttft_deadline = None if ttft_deadline_ms is None \
            else self.t_submit + ttft_deadline_ms / 1e3
        self._cancelled = False

    def _admitted(self):
        """What admission prefills: the prompt while the emitted tokens
        are to be regenerated, else ``seq``."""
        return self.prompt if self._replay else self.seq

    def _expired(self, now):
        """Which deadline (if any) has passed — checked at round
        boundaries and at admission (host clock only)."""
        if self._deadline is not None and now >= self._deadline:
            return True
        return self._ttft_deadline is not None and self.t_first is None \
            and now >= self._ttft_deadline

    def result(self):
        if not self.done:
            raise MXNetError("request %s is not finished" % self.id)
        if self.error is not None:
            raise self.error
        return np.asarray(self.tokens, np.int32)

    def __repr__(self):
        return ("Request(id=%r, prompt_len=%d, max_tokens=%d, done=%s, "
                "generated=%d)" % (self.id, len(self.prompt),
                                   self.max_tokens, self.done,
                                   len(self.tokens)))


class _PlacementError:
    """Marker riding a staged ``(req, dev)`` tuple when ``_place_prompt``
    failed: admission retires the request with the carried error instead
    of serving it."""

    def __init__(self, error):
        self.error = error


class _PendingSource:
    """StagedStream source over the engine's pending deque (empty deque =
    StopIteration; the stream runs ``live_source`` mode, so submits
    arriving later are staged by the very next fill)."""

    def __init__(self, dq):
        self._dq = dq

    def next(self):
        if not self._dq:
            raise StopIteration
        return self._dq.popleft()

    def reset(self):
        pass


class _CompileLog(list):
    """The compile log (``compile_counts`` reads it) that also counts each
    build in the ``serving.compiles_*`` telemetry."""

    def append(self, tag):
        _TM_COMPILES[tag if isinstance(tag, str) else tag[0]].inc()
        super().append(tag)


# what close() drops: every device tensor the engine owns (caches, the
# prefix pool, the staging caches, the state vectors, its own weight copy)
_DEVICE_STATE = ("_groups", "_cache_bufs", "_caches", "_stage_groups",
                 "_stage", "_pos", "_tok", "_live", "_eos", "_last",
                 "_temp", "_uniform", "_params", "_aux", "_draft_groups",
                 "_draft_caches", "_draft_stage_groups", "_draft_stage",
                 "_draft_params", "_draft_aux", "_handoff_stage")

# the prefill operands after the padded piece: slot, chunk start, the
# piece's true length, final (0/1), the temperature's float32 bits, seed,
# EOS id (-1: none), the request's token budget (the JAX ``_prefill_fn``'s
# traced operands, in its order, the PRNG key as the seed)
_N_SCALARS = 8
# the draft prefill's: slot, chunk start, the piece's true length
_N_DRAFT_SCALARS = 3


def _default_buckets(max_len):
    out, b = [], 16
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def _leaves(tree):
    """The buffers of a cache tree (sharded: rank by rank), in order."""
    return [b for t in rank_trees(tree) for e in t for b in e]


def _unflatten(tree, leaves):
    """A tree shaped like ``tree`` (sharded or not) over ``leaves``."""
    it = iter(leaves)
    out = [[tuple(next(it) for _ in e) for e in t] for t in rank_trees(tree)]
    return out if rank_trees(tree) is tree else out[0]


def _grouped_cache(one, slots, rows):
    """Cache buffers laid out like ``one`` (``Decoder.init_cache(1)``,
    sharded or not) for ``slots`` slots of ``rows`` rows, every buffer of
    one rank, dtype and row shape in ONE allocation ``[count, slots, rows,
    ...]`` on the rank's device (K/V zeroed, int8 row scales one, ring
    positions -1, as ``init_cache`` has them). A windowed node's ring is
    not addressed by absolute row: its buffers keep their ``window`` rows
    whatever ``rows`` is, in allocations of their own. Returns ``(groups,
    caches)``: the allocations (rank by rank), and a tree shaped like
    ``one`` of ``[slots, rows, ...]`` views (each contiguous, as the
    kernels take them), so that a copy between slots runs one kernel a
    group instead of one a buffer."""
    keys, counts, where = _group_layout(one)
    devs = {}
    for (g, _), b in zip(where, _leaves(one)):
        devs.setdefault(g, b.device)
    groups = [torch.full((n, slots, ring or rows) + tail,
                         CACHE_FILL[2 + len(tail)], dtype=dt,
                         device=devs[g])
              for g, (n, (_, dt, tail, ring)) in enumerate(zip(counts,
                                                                keys))]
    return groups, _unflatten(one, [groups[g][i] for g, i in where])


def _group_layout(one):
    """How :func:`_grouped_cache` groups the buffers of ``one``: the
    ``(rank, dtype, row shape, ring rows or None)`` of each allocation,
    its buffer count, and ``(allocation, index)`` of each buffer in
    :func:`_leaves` order."""
    keys, counts, where = [], [], []
    for r, t in enumerate(rank_trees(one)):
        for entry in t:
            ring = entry[0].shape[1] if ring_entry(entry) else None
            for b in entry:
                key = (r, b.dtype, tuple(b.shape[2:]), ring)
                if key not in keys:
                    keys.append(key)
                    counts.append(0)
                g = keys.index(key)
                where.append((g, counts[g]))
                counts[g] += 1
    return keys, counts, where


def _wide(t):
    """``t`` viewed as the widest integer type its rows divide into: a
    copy between slots then moves the same bytes in a quarter (bf16) or
    an eighth (int8) of the elements."""
    nb = t.shape[-1] * t.element_size()
    for dt, size in ((torch.int64, 8), (torch.int32, 4), (torch.int16, 2)):
        if size >= t.element_size() and nb % size == 0:
            return t.view(dt)
    return t


def _nbytes(caches):
    return sum(b.numel() * b.element_size() for b in _leaves(caches))


def _device_key(d):
    """``d`` as a ``torch.device`` with its index (``cuda`` is ``cuda:0``
    when nothing else is current)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device()
                         if torch.cuda.is_available() else 0)
    return d


def _resolve_parallel(tp, ep, mesh, decoder):
    """The tensor- and expert-parallel degrees and the mesh, as the JAX
    package resolves them (its l.794-860): ``MXNET_SERVING_TP`` and
    ``MXNET_SERVING_EP`` are the defaults; a mesh needs a ``model`` axis
    and wins the tp degree, a ``tp`` that differs from it disagrees; ep > 1
    needs a MoE decoder whose expert counts it divides, and a mesh whose
    ``expert`` axis has ep ranks. Without a mesh, ep > 1 builds
    ``build_mesh({"expert": ep, "model": tp})`` over ``[device] * (ep *
    tp)``; tp > 1 alone takes ``["cpu"] * tp`` on the host (the caller
    asked for it) and the visible cards on CUDA. Every rank must name the
    decoder's device: the engine's programs are single-device (CUDA
    graphs), so a mesh over distinct devices, or across processes,
    belongs to a later slice.
    Returns ``(tp, ep, mesh)``, the mesh None at tp = ep = 1."""
    device = decoder.device
    if mesh is None and tp is None:
        tp = int(os.environ.get("MXNET_SERVING_TP", "") or 1)
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise MXNetError(
                "InferenceEngine: mesh must be a parallel.Mesh "
                "(parallel.model_parallel_mesh builds one), got %r"
                % type(mesh).__name__)
        if "model" not in mesh.axis_names:
            raise MXNetError(
                "InferenceEngine: mesh=... needs a 'model' axis to shard "
                "the KV cache over (axes: %r) — parallel."
                "model_parallel_mesh builds one" % (mesh.axis_names,))
        if tp is not None and int(tp) != int(mesh.shape["model"]):
            raise MXNetError(
                "InferenceEngine: tp=%r disagrees with the mesh's model "
                "axis size %d — pass one or the other"
                % (tp, mesh.shape["model"]))
        tp = int(mesh.shape["model"])
        if mesh.is_multiprocess:
            # the engine's programs run on this process's device, as the
            # JAX engine has no path across processes
            raise later_slice("InferenceEngine", "serving over a mesh "
                              "across processes (%r)" % (mesh,))
    tp = int(tp)
    if tp < 1:
        raise MXNetError("InferenceEngine: tp must be >= 1 (1 = unsharded; "
                         "MXNET_SERVING_TP sets the default), got %d" % tp)
    if ep is None:
        ep = int(os.environ.get("MXNET_SERVING_EP", "") or 1)
    ep = int(ep)
    if ep < 1:
        raise MXNetError("InferenceEngine: ep must be >= 1 (1 = no expert "
                         "sharding; MXNET_SERVING_EP sets the default), "
                         "got %d" % ep)
    if ep > 1:
        moe_nodes = [n for n in decoder._topo
                     if not n.is_var and n.spec.name == "MoEFFN"]
        if not moe_nodes:
            raise MXNetError(
                "InferenceEngine: ep=%d needs a MoE decoder — no MoEFFN "
                "node to shard experts over" % ep)
        for n in moe_nodes:
            nx = int(n.params["num_experts"])
            if nx % ep:
                raise MXNetError(
                    "InferenceEngine: ep=%d must divide num_experts=%d "
                    "(node %r) — the expert stacks shard their leading "
                    "axis evenly" % (ep, nx, n.name))
        if mesh is not None:
            if "expert" not in mesh.axis_names \
                    or int(mesh.shape["expert"]) != ep:
                raise MXNetError(
                    "InferenceEngine: ep=%d disagrees with the mesh's "
                    "expert axis (axes: %r) — parallel.build_mesh("
                    "{'expert': ep, 'model': tp}) builds a composed mesh"
                    % (ep, mesh.axis_names))
        else:
            mesh = build_mesh({"expert": ep, "model": tp},
                              [device] * (ep * tp))
    elif tp == 1:
        return 1, 1, None
    elif mesh is None:
        mesh = model_parallel_mesh(
            tp, devices=[device] * tp if device.type == "cpu" else None)
    devs = sorted({str(_device_key(d)) for d in mesh.devices.ravel()})
    if len(devs) > 1:
        raise later_slice(
            "InferenceEngine", "tensor- or expert-parallel serving over "
            "distinct devices (%s; the engine's programs each run on one "
            "device: pass a mesh whose ranks all name it, e.g. "
            "model_parallel_mesh(%d, devices=[%r] * %d))"
            % (", ".join(devs), tp, str(device), tp))
    if devs[0] != str(_device_key(device)):
        raise MXNetError(
            "InferenceEngine: the mesh lies on %s, the decoder on %s"
            % (devs[0], device))
    return tp, ep, mesh


def _expert_shards(v, ranks):
    """An expert-stacked parameter (a tensor or a :class:`QuantizedTensor`
    with the expert axis first) as a list of its rank shards, rank ``r``
    holding experts ``[r X/n, (r+1) X/n)`` in one allocation of its own on
    its device ``ranks[r]`` (a quantized stack: its values and its scales
    each)."""
    n = len(ranks)

    def cut(t):
        return [c.to(d).clone(memory_format=torch.contiguous_format)
                for c, d in zip(t.chunk(n, dim=0), ranks)]

    if isinstance(v, QuantizedTensor):
        return [QuantizedTensor(q, sc, v.dtype, bits=v.bits, group=v.group)
                for q, sc in zip(cut(v.q), cut(v.scale))]
    return cut(v)


class InferenceEngine:
    """Continuous-batching serving loop over a :class:`Decoder`.

    Parameters
    ----------
    decoder : Decoder
        The derived incremental program (paged or dense, windowed rings;
        int8 or float KV; GQA, rope).
    slots : int
        ``S``, the resident-sequence capacity (the decode batch).
    prefill_buckets : tuple of int, optional
        Ascending prompt-padding lengths (default: powers of two from 16,
        capped at ``max_len``); a prompt (or a chunk piece) takes the
        smallest bucket that holds it.
    max_queue : int
        Submitted-but-not-admitted requests beyond which ``submit``
        follows the ``overload`` policy.
    stage_depth : int
        Requests whose padded prompt is copied host -> device ahead of
        admission (``io.StagedStream``); a prompt that will admit in
        pieces stages nothing.
    drain_depth : int
        Decode rounds whose tokens may stay on the card while work is in
        flight; a slot frees at most this many rounds after its sequence
        finished (the card freezes finished slots meanwhile). Speculation
        drains every round before it drafts.
    steps_per_round : int
        Decode steps per plain decode round (one [steps, S] token drain
        per round).
    prefix_cache_mb : float, optional
        Device bytes (MiB) of the prefix-reuse pool: retained prompt K/V
        that later prompts sharing a prefix copy instead of prefilling.
        ``None`` reads ``MXNET_SERVING_PREFIX_CACHE_MB``, else 64, as the
        JAX package does; 0 turns it off. The pool holds ``budget //
        (one slot's cache bytes)`` slots, at most 256.
    prefill_chunk : int, optional
        Prefill at most this many tokens of one prompt per round (a long
        prompt admits in pieces between decode rounds, and prompts up to
        ``max_len - 1`` are served); ``None`` reads
        ``MXNET_SERVING_PREFILL_CHUNK``, else 0 (whole prompts).
    overload : {"block", "shed", "shed_oldest"}, optional
        What a full queue does to ``submit`` (``None`` reads
        ``MXNET_SERVING_OVERLOAD``, else ``"block"``): ``block`` raises a
        generic ``MXNetError`` (callers drive ``step`` to drain it),
        ``shed`` fails the NEW request with :class:`EngineOverloaded`,
        ``shed_oldest`` evicts the oldest queued (never admitted) request
        instead. Under either shedding policy prefix-cache retention
        pauses while the queue is full. A mutable attribute.
    round_timeout_ms : float, optional
        Round watchdog (``None`` reads ``MXNET_SERVING_ROUND_TIMEOUT_MS``,
        else 0 = off): draining a dispatched round first polls the CUDA
        event recorded after its dispatch, and raises
        :class:`EngineStuck` after this long instead of blocking on a
        wedged round. The undrained round stays queued. A mutable
        attribute; rounds dispatched while it was 0 carry no event and
        drain blocking.
    slo_ttft_ms, slo_cadence_ms : float, optional
        SLO targets (``None`` reads ``MXNET_SERVING_SLO_TTFT_MS`` /
        ``MXNET_SERVING_SLO_CADENCE_MS``, else no SLO accounting): each
        served request ticks ``serving.slo_*_attained`` or ``_missed``,
        and the burn-rate gauges ``serving.slo_*_burn_{1m,5m,1h}`` are
        refreshed each round. ``slo_target`` (0.99) is the attainment
        objective the burn rates are normalized against.
    flight_recorder : int, optional
        Retired requests whose lifecycle timeline
        ``engine.flight.timeline(id)`` keeps (``None`` reads
        ``MXNET_SERVING_FLIGHT_RECORDER``, else 256; 0 disables).
    spec_k : int, optional
        Drafted tokens per slot and verify round; ``None`` reads
        ``MXNET_SERVING_SPEC_K``, else 4.
    draft : {"off", "ngram", "model"}, optional
        Speculative decoding's drafter: none, the request's own n-gram
        history (:class:`~mxnet_tpu_torch.serving.spec.NgramDrafter`) or
        ``draft_decoder``. ``None`` reads ``MXNET_SERVING_DRAFT``, else
        ``"off"``.
    draft_decoder : Decoder, optional
        The draft model for ``draft="model"`` (same ``max_len`` and
        device; under an int8 engine the engine quantizes its own copy of
        a float draft).
    weight_dtype : {"float", "int8", "int4"}, optional
        Weight storage for the engine (default: the decoder's). Over a
        float decoder the engine quantizes its OWN copy, so one decoder
        can serve a quantized engine beside its float oracle.
    weight_group : int, optional
        int4 group width.
    attn_impl, matmul_impl : optional
        Default to the decoder's. ``attn_impl`` is the read of the decode,
        verify and draft programs (a prefill reads as the decoder does):
        ``"paged"``, or ``"dense"`` over a decoder built dense (over a
        paged one it raises, as in the JAX package). A windowed decoder
        asked for ``"paged"`` warns and serves its dense ring read; it
        also serves without a prefix pool, without speculation (asked
        for, it warns and turns it off) and only as ``role="unified"``.
    engine_id : str, optional
        Names this engine (default ``"e<pid>.<n>"``, unique in the
        process); ``migrated_from`` is the donor's id when ``restore()``
        built it.
    capture_dir : str, optional
        Traffic capture (:mod:`.capture`): every accepted submit and its
        retirement go to a fresh ``mx_capture_<pid>_<n>.jsonl`` in this
        directory (``None`` reads ``MXNET_SERVING_CAPTURE_DIR``; unset is
        off), bounded by ``capture_mb`` (``None`` reads
        ``MXNET_SERVING_CAPTURE_MB``, else 64). ``snapshot()`` carries the
        directory, so a restored engine captures on into a new file.
    role : {"unified", "prefill", "decode"}, optional
        ``None`` reads ``MXNET_SERVING_ROLE``, else ``"unified"``. A
        prefill engine admits and prefills only and packages each first
        token's request as a :class:`~.handoff.KVHandoff`
        (:meth:`take_handoffs`); it never runs a decode or verify program.
        A decode engine refuses ``submit`` and admits packages
        (:meth:`admit_handoff`); it never runs a prefill program.
    handoff_dtype : {"native", "int8"}, optional
        How this engine's exported rows travel (``None`` reads
        ``MXNET_SERVING_HANDOFF_DTYPE``, else ``"native"``):
        :func:`~.handoff.pack_rows`.
    tp, mesh : optional
        Tensor-parallel serving: the KV cache and the attention sharded
        over ``tp`` ranks of ``mesh``'s ``model`` axis (a
        :class:`~mxnet_tpu_torch.parallel.Mesh`; ``model_parallel_mesh(2,
        devices=["cuda:0"] * 2)`` runs two ranks on one card). ``tp=None``
        reads ``MXNET_SERVING_TP``, else 1; a mesh gives the degree, and a
        ``tp`` that differs from it raises. Without a mesh a CPU engine
        runs its ranks on the host and a CUDA one takes the visible cards.
        Every rank must name the decoder's device (a mesh over distinct
        cards, or across processes, belongs to a later slice), and the
        kv heads of the target and draft models must divide by ``tp``.
        Greedy streams equal tp=1's.
    ep : optional
        Expert parallelism of a MoE decoder: every input of each MoE node
        but its data (the gate and the four expert stacks; a quantized
        stack's values and scales) held as ``ep`` rank shards of ``X/ep``
        experts, one allocation a rank, and every program running the walk
        with ``ep=("expert", ep)``. ``None`` reads ``MXNET_SERVING_EP``,
        else 1. ep > 1 needs a MoE decoder whose expert counts it divides;
        a ``mesh`` needs an ``expert`` axis of ``ep`` ranks (and a
        ``model`` axis, of ``tp`` ranks); without one the engine builds
        ``build_mesh({"expert": ep, "model": tp})`` over ``[device] * (ep
        * tp)``: ranks on the one device, as for ``tp``. Greedy streams
        equal ep=1's (``ops.attention.moe_ffn_math``: the logits are ep=1's
        bitwise where each expert's products are).
    """

    def __init__(self, decoder, slots=8, prefill_buckets=None,
                 max_queue=256, stage_depth=2, drain_depth=2,
                 steps_per_round=1, prefix_cache_mb=None,
                 prefill_chunk=None, overload=None,
                 round_timeout_ms=None, slo_ttft_ms=None,
                 slo_cadence_ms=None, slo_target=0.99,
                 flight_recorder=None, spec_k=None, draft=None,
                 draft_decoder=None, attn_impl=None, capture_dir=None,
                 capture_mb=None, tp=None, mesh=None,
                 weight_dtype=None, weight_group=None, matmul_impl=None,
                 ep=None, engine_id=None, migrated_from=None,
                 role=None, handoff_dtype=None):
        if not isinstance(decoder, Decoder):
            raise MXNetError("InferenceEngine needs a Decoder, got %r"
                             % type(decoder).__name__)
        self.tp, self.ep, self._mesh = _resolve_parallel(tp, ep, mesh,
                                                         decoder)
        # the walk's tp and ep operands, and the cache layout it reads
        self._tp_ax = ("model", self.tp) if self.tp > 1 else None
        self._ep_ax = ("expert", self.ep) if self.ep > 1 else None
        self._kv_shard = None if self.tp == 1 else NamedSharding(
            self._mesh, PartitionSpec(None, None, "model"))
        if self.tp > 1:
            for n in decoder._mha:
                _MHA.check_head_shards(n.params, self.tp)
        self._dec = decoder
        self._t0 = time.perf_counter()   # ledger and capture time origin
        self.engine_id = str(engine_id) if engine_id is not None \
            else "e%d.%d" % (os.getpid(), next(_ENGINE_SEQ))
        self.migrated_from = None if migrated_from is None \
            else str(migrated_from)
        self.device = decoder.device
        self.max_len = decoder.max_len
        self.slots = int(slots)
        if self.slots < 1:
            raise MXNetError("InferenceEngine: slots must be >= 1")
        if prefill_buckets is None:
            prefill_buckets = _default_buckets(self.max_len)
        buckets = tuple(int(b) for b in prefill_buckets)
        if not buckets or list(buckets) != sorted(set(buckets)) \
                or buckets[0] < 1 or buckets[-1] > self.max_len:
            raise MXNetError(
                "InferenceEngine: prefill_buckets must be strictly "
                "ascending lengths in [1, max_len], got %r" % (buckets,))
        self.prefill_buckets = buckets
        self.max_queue = int(max_queue)
        self._drain_depth = max(0, int(drain_depth))
        self.steps_per_round = int(steps_per_round)
        if self.steps_per_round < 1:
            raise MXNetError("InferenceEngine: steps_per_round must "
                             "be >= 1")
        if prefill_chunk is None:
            prefill_chunk = int(os.environ.get(
                "MXNET_SERVING_PREFILL_CHUNK", "0") or 0)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 0:
            raise MXNetError("InferenceEngine: prefill_chunk must be "
                             ">= 0 (0 disables chunking)")
        if self.prefill_chunk > buckets[-1]:
            raise MXNetError(
                "InferenceEngine: prefill_chunk=%d exceeds the largest "
                "prefill bucket %d — every chunk piece must fit a "
                "bucket program" % (self.prefill_chunk, buckets[-1]))
        if overload is None:
            overload = os.environ.get("MXNET_SERVING_OVERLOAD") \
                or "block"
        if overload not in ("block", "shed", "shed_oldest"):
            raise MXNetError(
                "InferenceEngine: overload must be 'block', 'shed' or "
                "'shed_oldest', got %r (MXNET_SERVING_OVERLOAD sets "
                "the default)" % (overload,))
        self.overload = overload
        if round_timeout_ms is None:
            round_timeout_ms = float(os.environ.get(
                "MXNET_SERVING_ROUND_TIMEOUT_MS") or "0")
        self.round_timeout_ms = float(round_timeout_ms)
        if self.round_timeout_ms < 0:
            raise MXNetError("InferenceEngine: round_timeout_ms must "
                             "be >= 0 (0 disables the watchdog)")
        if slo_ttft_ms is None:
            slo_ttft_ms = os.environ.get("MXNET_SERVING_SLO_TTFT_MS")
            slo_ttft_ms = float(slo_ttft_ms) if slo_ttft_ms else None
        if slo_cadence_ms is None:
            slo_cadence_ms = os.environ.get(
                "MXNET_SERVING_SLO_CADENCE_MS")
            slo_cadence_ms = float(slo_cadence_ms) if slo_cadence_ms \
                else None
        for nm, v in (("slo_ttft_ms", slo_ttft_ms),
                      ("slo_cadence_ms", slo_cadence_ms)):
            if v is not None and not v > 0:
                raise MXNetError("InferenceEngine: %s must be > 0 "
                                 "(None disables SLO accounting), got "
                                 "%r" % (nm, v))
        if not 0.0 < float(slo_target) < 1.0:
            raise MXNetError("InferenceEngine: slo_target must be in "
                             "(0, 1), got %r" % (slo_target,))
        self.slo_ttft_ms = slo_ttft_ms
        self.slo_cadence_ms = slo_cadence_ms
        self.slo_target = float(slo_target)
        self._slo_windows = {}
        if flight_recorder is None:
            flight_recorder = int(os.environ.get(
                "MXNET_SERVING_FLIGHT_RECORDER", "") or 256)
        if int(flight_recorder) < 0:
            raise MXNetError("InferenceEngine: flight_recorder must "
                             "be >= 0 (0 disables the recorder)")
        self.flight = FlightRecorder(retain=int(flight_recorder))
        self.stage_depth = int(stage_depth)
        if prefix_cache_mb is None:
            prefix_cache_mb = float(os.environ.get(
                "MXNET_SERVING_PREFIX_CACHE_MB") or "64")
        self.prefix_cache_mb = float(prefix_cache_mb)
        if self.prefix_cache_mb < 0:
            raise MXNetError("InferenceEngine: prefix_cache_mb must "
                             "be >= 0 (0 disables the prefix cache)")
        self._windowed = any(decoder._node_window(n) for n in decoder._mha)
        # the read the decode, verify and draft programs run (threaded into
        # every Decoder._run_slots); a prefill reads as the decoder does
        if attn_impl is None:
            attn_impl = decoder._attn_impl
        if attn_impl not in ("dense", "paged"):
            raise MXNetError(
                "InferenceEngine: attn_impl must be 'dense' or 'paged', got "
                "%r (MXNET_SERVING_ATTN_IMPL sets the default)"
                % (attn_impl,))
        if attn_impl == "dense" and decoder._attn_impl == "paged":
            raise MXNetError(
                "InferenceEngine: attn_impl='dense' over a Decoder built "
                "with attn_impl='paged' — build the decoder dense; the "
                "engine threads its own attn_impl into the slot programs")
        if attn_impl == "paged" and self._windowed:
            warnings.warn(
                "InferenceEngine: windowed-ring decoders do not compose "
                "with attn_impl='paged' (ring rows live at wrapped "
                "positions, not a [0, pos) prefix) — serving with the "
                "exact dense ring walk instead", UserWarning, stacklevel=2)
            attn_impl = "dense"
        self.attn_impl = attn_impl
        if matmul_impl is None:
            matmul_impl = decoder._matmul_impl
        if matmul_impl not in ("dense", "pallas", "fused"):
            raise MXNetError(
                "InferenceEngine: matmul_impl must be 'dense', 'pallas' "
                "or 'fused', got %r" % (matmul_impl,))
        self.matmul_impl = matmul_impl
        # disaggregated prefill/decode: the role gates which program
        # families ever run (a scheduler gate: the programs are built at
        # first use, so nothing extra is built either way)
        if role is None:
            role = os.environ.get("MXNET_SERVING_ROLE") or "unified"
        if role not in ("unified", "prefill", "decode"):
            raise MXNetError(
                "InferenceEngine: role must be 'unified', 'prefill' or "
                "'decode', got %r (MXNET_SERVING_ROLE sets the default)"
                % (role,))
        if role != "unified" and self._windowed:
            raise MXNetError(
                "InferenceEngine: windowed-ring decoders do not compose "
                "with role=%r — ring rows live at wrapped positions, "
                "outside the [0, P) prefix contract the KV handoff rows "
                "ride (slot_prefix_rows); serve unified" % (role,))
        self.role = role
        if handoff_dtype is None:
            handoff_dtype = os.environ.get(
                "MXNET_SERVING_HANDOFF_DTYPE") or "native"
        if handoff_dtype not in HANDOFF_DTYPES:
            raise MXNetError(
                "InferenceEngine: handoff_dtype must be one of %s, got %r "
                "(MXNET_SERVING_HANDOFF_DTYPE sets the default)"
                % (", ".join(map(repr, HANDOFF_DTYPES)), handoff_dtype))
        self.handoff_dtype = handoff_dtype
        # a draining replica takes no NEW submits (FleetRouter.drain sets
        # it; health() reports it)
        self.draining = False
        _TM_ROLE.set({"unified": 0, "prefill": 1, "decode": 2}[role])

        if weight_dtype is None:
            weight_dtype = decoder.weight_dtype
        if weight_dtype not in ("float", "int8", "int4"):
            raise MXNetError(
                "InferenceEngine: weight_dtype must be 'float', 'int8' or "
                "'int4', got %r" % (weight_dtype,))
        if decoder.weight_dtype != "float" \
                and weight_dtype != decoder.weight_dtype:
            raise MXNetError(
                "InferenceEngine: weight_dtype=%r over a Decoder already "
                "quantized to %r — build the decoder float (the engine "
                "quantizes its own copy)"
                % (weight_dtype, decoder.weight_dtype))
        self.weight_dtype = weight_dtype
        self.weight_group = weight_group if weight_group is not None \
            else decoder.weight_group
        params = decoder._params
        if weight_dtype != "float" and decoder.weight_dtype == "float":
            params = quantize_params(
                params, quantized_weight_names(decoder._topo),
                bits=8 if weight_dtype == "int8" else 4,
                group=self.weight_group,
                row_quant=decoder._embedding_weight_names())
        if self.ep > 1:
            # the engine's own copy: each MoE node's gate and stacks as
            # rank shards on the expert axis (quantized first: a row's
            # scale is its own, so shards quantize as the whole does)
            ranks = self._mesh.axis_devices("expert")
            experts = {inp.name for n in decoder._topo
                       if not n.is_var and n.spec.name == "MoEFFN"
                       for inp, _ in n.inputs[1:]}
            params = {k: _expert_shards(v, ranks) if k in experts else v
                      for k, v in params.items()}
        self._params, self._aux = params, decoder._aux

        # speculative decoding
        if draft is None:
            draft = os.environ.get("MXNET_SERVING_DRAFT") or "off"
        if draft not in ("off", "ngram", "model"):
            raise MXNetError(
                "InferenceEngine: draft must be 'off', 'ngram' or "
                "'model', got %r (MXNET_SERVING_DRAFT sets the "
                "default)" % (draft,))
        if spec_k is None:
            spec_k = int(os.environ.get("MXNET_SERVING_SPEC_K", "") or 4)
        self.spec_k = int(spec_k)
        if draft != "off":
            if self.spec_k < 1:
                raise MXNetError(
                    "InferenceEngine: spec_k must be >= 1 when draft "
                    "is on, got %d (MXNET_SERVING_SPEC_K sets the "
                    "default)" % self.spec_k)
            if self.spec_k > self.max_len - 3:
                raise MXNetError(
                    "InferenceEngine: spec_k=%d leaves no room in the "
                    "max_len=%d cache for a verify chunk (need "
                    "spec_k <= max_len - 3)" % (self.spec_k, self.max_len))
            if self._windowed:
                warnings.warn(
                    "InferenceEngine: windowed-ring decoders do not "
                    "compose with speculative decoding (the verify chunk "
                    "would wrap rejected drafts onto live ring rows) — "
                    "serving with draft='off'", UserWarning, stacklevel=2)
                draft = "off"
        self.spec_draft = draft
        self._spec = draft != "off"
        self._drafters = {}           # request id -> NgramDrafter
        self._draft_dec = None
        wbytes = self._weight_nbytes(params)
        if draft == "model":
            self._draft_dec = self._check_draft(draft_decoder)
            if self.tp > 1:
                for n in draft_decoder._mha:
                    _MHA.check_head_shards(
                        n.params, self.tp,
                        where="tensor-parallel draft serving")
            dparams = draft_decoder._params
            if self.weight_dtype == "int8" \
                    and draft_decoder.weight_dtype != "int8":
                # the draft model reads its weights every proposal
                # round: quantize it with the target (the engine's copy)
                dparams = quantize_params(
                    dparams, quantized_weight_names(draft_decoder._topo),
                    row_quant=draft_decoder._embedding_weight_names())
            self._draft_params = dparams
            self._draft_aux = draft_decoder._aux
            wbytes += self._weight_nbytes(dparams)
        self.weight_bytes = wbytes

        # device-resident, at fixed addresses for the engine's life (the
        # programs update them in place): the slot cache and the prefix
        # pool (one set of buffers), the one-slot staging cache a prefill
        # runs over, and the per-slot state
        S, dev = self.slots, self.device
        # sharded under tp (one tree a rank); the byte budgets count every
        # rank's share, so that they do not depend on the degree
        one = decoder.init_cache(1, kv_sharding=self._kv_shard)
        slot_bytes = _nbytes(one)
        pool = 0
        # a ring row is addressed by its wrapped position, not by a prompt
        # prefix: a windowed decoder has no prefix pool
        if self.prefix_cache_mb > 0 and not self._windowed:
            pool = min(int(self.prefix_cache_mb * 2 ** 20)
                       // max(1, slot_bytes), _MAX_POOL_SLOTS)
        self._groups, self._cache_bufs = _grouped_cache(
            one, S + pool, self.max_len)
        self._caches = _unflatten(self._cache_bufs,
                                  [b[:S] for b in _leaves(self._cache_bufs)])
        self._prefix = PrefixCache(pool, slot_bytes) if pool else None
        # a piece at a late start runs its pad rows past max_len: the
        # staging cache has room for them (only rows below max_len are
        # written back to a slot)
        self._stage_groups, self._stage = _grouped_cache(
            one, 1, self.max_len + buckets[-1])
        del one
        self._pos = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._tok = torch.zeros((S,), dtype=torch.int64, device=dev)
        self._live = torch.zeros((S,), dtype=torch.bool, device=dev)
        self._eos = torch.full((S,), -1, dtype=torch.int64, device=dev)
        self._last = torch.zeros((S,), dtype=torch.int32, device=dev)
        self._temp = torch.zeros((S,), dtype=torch.float32, device=dev)
        # each slot's uniform draw at every position, from its request's
        # seed (written by the prefill; a decode step gathers one a slot)
        self._uniform = torch.zeros((S, self.max_len), dtype=torch.float32,
                                    device=dev)
        if self._draft_dec is not None:
            one = self._draft_dec.init_cache(1, kv_sharding=self._kv_shard)
            self._draft_groups, self._draft_caches = _grouped_cache(
                one, S, self.max_len)
            self._draft_stage_groups, self._draft_stage = _grouped_cache(
                one, 1, self.max_len + buckets[-1])
            del one
            self._draft_pos = [0] * S     # next draft-cache position
            self._draft_pending = [[] for _ in range(S)]
        self._programs = {}
        self._handoff_stage = {}     # bucket -> staging allocations
        self._compile_log = _CompileLog()
        _TM_ATTN_IMPL.set(1 if self.attn_impl == "paged" else 0)
        _TM_TP.set(self.tp)
        # what one rank holds of the slot cache: its share of the K/V and
        # whole copies of the ring positions
        _TM_TP_KV_BYTES.set(_nbytes(rank_trees(self._caches)[0]))
        _TM_WEIGHT_DTYPE.set(
            {"float": 0, "int8": 1, "int4": 2}[self.weight_dtype])
        _TM_WEIGHT_BYTES.set(wbytes)
        _TM_MATMUL_IMPL.set(
            {"dense": 0, "pallas": 1, "fused": 2}[self.matmul_impl])
        _TM_WEIGHT_GROUP.set(int(self.weight_group or 0))

        # host-side scheduler state
        self._pending = collections.deque()
        self._stager = StagedStream(_PendingSource(self._pending),
                                    place=self._place_prompt,
                                    depth=stage_depth, live_source=True)
        self._free = collections.deque(range(S))   # FIFO slot recycling
        self._mirror = [None] * S    # drain-side view: slot -> Request
        self._drain = collections.deque()
        # requests admitted to a slot whose prompt is still prefilled in
        # pieces, oldest first; plus one admission candidate held over
        # when a round's prefill budget ran out
        self._chunking = collections.deque()
        self._held = None
        self._round_budget = float("inf")
        self._next_id = 0
        self._auto_seed = 0
        # request lifecycle: every not-yet-done request, in submission
        # order (snapshot/restore replays this order); _watched is the
        # subset that can retire host-side (deadline or cancel), so the
        # per-round sweep never walks a deadline-less backlog
        self._active = {}            # id -> Request
        self._watched = set()        # ids with a deadline / cancel mark
        self._done_buf = []          # finished since the last step()
        self._closed = False
        # KV handoff state: _handoff_out holds packaged finished prefills
        # until the router takes them; _handoff_slots are the slots those
        # packages pin (out of _free, carrying no live request, until the
        # package resolves); _imported is a bounded id ring for
        # exactly-once admission under retried deliveries
        self._handoff_out = collections.deque()
        self._handoff_slots = set()
        self._imported = collections.OrderedDict()
        self.stats = {"submitted": 0, "completed": 0, "prefills": 0,
                      "steps": 0, "tokens": 0, "prefix_hits": 0,
                      "prefix_hit_tokens": 0, "prefill_chunks": 0,
                      "prefix_copies": 0, "shed": 0, "deadline_missed": 0,
                      "cancelled": 0, "errors": 0, "watchdog_trips": 0,
                      "restores": 0, "spec_rounds": 0,
                      "spec_fallback_rounds": 0, "spec_drafted": 0,
                      "spec_accepted": 0, "handoffs_out": 0,
                      "handoffs_in": 0}
        # the watchdog's state (health()), and the round-phase ledger:
        # _phase is the accumulator while a step() is in flight,
        # _rounds the bounded ledger round_table() reads
        self._last_ok_t = time.perf_counter()
        self._watchdog_stuck_t = None
        self._phase = None
        self._rounds = collections.deque(maxlen=_ROUND_LEDGER)
        self._round_no = 0
        # traffic capture, opened last so that the header carries the
        # final geometry; a disabled stream (knob unset) is a no-op
        self.capture = CaptureStream.open(
            capture_dir, capture_mb,
            dict(self._geometry(), max_len=self.max_len,
                 engine_id=self.engine_id,
                 migrated_from=self.migrated_from), self._t0)
        # resolved (the env default included) so snapshot() carries it
        self.capture_dir = os.path.dirname(self.capture.path) \
            if self.capture.enabled else None
        _ENGINES.add(self)

    @staticmethod
    def _weight_nbytes(params):
        return weight_nbytes(params)

    def _check_draft(self, ddec):
        """Validate ``draft_decoder`` as the JAX package does (l.1131)."""
        if not isinstance(ddec, Decoder):
            raise MXNetError(
                "InferenceEngine: draft='model' needs a draft_decoder (a "
                "Decoder over the small draft LM), got %r"
                % type(ddec).__name__)
        if ddec.max_len != self.max_len:
            raise MXNetError(
                "InferenceEngine: draft_decoder.max_len=%d must equal the "
                "target's max_len=%d (the draft cache mirrors the slot "
                "clocks)" % (ddec.max_len, self.max_len))
        if ddec.device != self.device:
            raise MXNetError(
                "InferenceEngine: draft_decoder lives on %s, the engine "
                "on %s" % (ddec.device, self.device))
        if self.attn_impl == "dense" and ddec._attn_impl == "paged":
            raise MXNetError(
                "InferenceEngine: attn_impl='dense' over a draft_decoder "
                "built with attn_impl='paged' — build the draft decoder "
                "dense (the engine threads its attn_impl into the draft "
                "program)")
        if self.weight_dtype == "float" and ddec.weight_dtype == "int8":
            raise MXNetError(
                "InferenceEngine: weight_dtype='float' over a "
                "draft_decoder built with weight_dtype='int8' — build the "
                "draft decoder float (the engine quantizes its own copy)")
        return ddec

    @classmethod
    def from_checkpoint(cls, prefix, epoch, max_len, slots=8,
                        prefill_buckets=None, max_queue=256,
                        stage_depth=2, drain_depth=2, steps_per_round=1,
                        prefix_cache_mb=None, prefill_chunk=None,
                        overload=None, round_timeout_ms=None,
                        slo_ttft_ms=None, slo_cadence_ms=None,
                        slo_target=0.99, flight_recorder=None,
                        spec_k=None, draft=None, draft_decoder=None,
                        draft_prefix=None, draft_epoch=None,
                        attn_impl=None, capture_dir=None, tp=None,
                        mesh=None, weight_dtype=None,
                        **decoder_kwargs):
        """Checkpoint -> serving engine in one call (``prefix-symbol.json``
        + ``prefix-NNNN.params``), with the JAX package's parameters in
        its order. ``weight_dtype`` goes to the decoder, and so do
        ``decoder_kwargs`` (``compute_dtype``, ``matmul_impl``,
        ``cache_dtype``, ``device`` ...). ``draft_prefix``/``draft_epoch``
        load a SECOND checkpoint as the speculative draft model (epoch 0
        unless given; ``draft`` then defaults to ``"model"``); the draft
        decoder takes the ``compute_dtype``, ``weight_dtype`` and
        ``device`` but none of the cache-flavor kwargs. The unported
        parameters raise as in :class:`InferenceEngine`."""
        decoder_kwargs.setdefault("weight_dtype", weight_dtype)
        if attn_impl is not None:
            decoder_kwargs.setdefault("attn_impl", attn_impl)
        dec = Decoder.from_checkpoint(prefix, epoch, max_len,
                                      **decoder_kwargs)
        if draft_prefix is not None and draft_decoder is None:
            draft_decoder = Decoder.from_checkpoint(
                draft_prefix, 0 if draft_epoch is None else draft_epoch,
                max_len, cache_block=None, attn_impl=dec._attn_impl,
                compute_dtype=decoder_kwargs.get("compute_dtype"),
                weight_dtype=decoder_kwargs["weight_dtype"],
                device=decoder_kwargs.get("device"))
            if draft is None:
                draft = "model"
        return cls(dec, slots=slots, prefill_buckets=prefill_buckets,
                   max_queue=max_queue, stage_depth=stage_depth,
                   drain_depth=drain_depth,
                   steps_per_round=steps_per_round,
                   prefix_cache_mb=prefix_cache_mb,
                   prefill_chunk=prefill_chunk, overload=overload,
                   round_timeout_ms=round_timeout_ms,
                   slo_ttft_ms=slo_ttft_ms,
                   slo_cadence_ms=slo_cadence_ms, slo_target=slo_target,
                   flight_recorder=flight_recorder, spec_k=spec_k,
                   draft=draft, draft_decoder=draft_decoder,
                   capture_dir=capture_dir, tp=tp, mesh=mesh)

    # -- scheduling -----------------------------------------------------
    def _bucket_for(self, n):
        for b in self.prefill_buckets:
            if b >= n:
                return b
        raise MXNetError(
            "InferenceEngine: prompt length %d exceeds the largest "
            "prefill bucket %d" % (n, self.prefill_buckets[-1]))

    def _place_prompt(self, req):
        """Stager place function: pad the prompt to its bucket and copy it
        host -> device without blocking (up to ``stage_depth`` requests
        ahead of admission); the time lands on the round in flight.

        A sequence that will admit in pieces (longer than
        ``prefill_chunk``, or one past the largest bucket) stages
        nothing: the split depends on the prefix match. A prefix
        HIT on a short prompt also discards the staged tensor, but hits
        are unknowable this far ahead of admission. A placement failure
        poisons only ITS request: the error rides the staged tuple to
        admission."""
        th0 = time.perf_counter()
        try:
            return self._place_prompt_inner(req)
        finally:
            self._phase_add("h2d", time.perf_counter() - th0)

    def _place_prompt_inner(self, req):
        try:
            seq = req._admitted()
            p = len(seq)
            if (self.prefill_chunk and p > self.prefill_chunk) \
                    or p > self.prefill_buckets[-1]:
                self.flight.event(req.id, "staged", chunked=True)
                return req, None
            bucket = self._bucket_for(p)
            padded = np.zeros((bucket,), np.int64)
            padded[:p] = seq
            # a tensor of its own: the program's operand is written only
            # at admission (one device-to-device copy), and the caching
            # allocator hands this block on only in stream order
            dev = torch.empty((bucket,), dtype=torch.int64,
                              device=self.device)
            copy_in(dev, padded)
            self.flight.event(req.id, "staged", bucket=bucket)
            return req, dev
        except Exception as e:               # noqa: BLE001 — isolated
            self.flight.event(req.id, "staged", error=str(e))
            return req, _PlacementError(e)

    def queued(self):
        """Requests submitted but not yet admitted to a slot."""
        return len(self._pending) + self._stager.staged() \
            + (self._held is not None)

    @property
    def idle(self):
        # handoff-pinned slots count as free: the engine has nothing left
        # to step for them (delivery is the router's job, and
        # FleetRouter.idle waits for every unresolved package)
        return not self._pending and self._stager.staged() == 0 \
            and self._held is None \
            and len(self._free) + len(self._handoff_slots) == self.slots \
            and not self._drain and not self._chunking

    def _busy(self):
        return self.slots - len(self._free) - len(self._handoff_slots) > 0 \
            or bool(self._pending) or self._stager.staged() > 0 \
            or self._held is not None

    def submit(self, prompt, max_tokens, eos_id=None, temperature=0.0,
               seed=None, request_id=None, deadline_ms=None,
               ttft_deadline_ms=None, _resume_tokens=(), _trace=None):
        """Queue one generation request; returns its :class:`Request`.

        prompt: 1-D integer sequence, ``1 <= len <= max_len - 1``, and
        within the largest bucket unless ``prefill_chunk`` is on; at most
        ``max_len - len(prompt)`` tokens come back. ``eos_id`` stops
        generation after it is emitted. ``temperature=0`` is greedy; > 0
        samples with ``seed`` (drawn from a counter when omitted).

        ``deadline_ms`` / ``ttft_deadline_ms`` (host wall clock from
        submit): past the deadline — overall, or first-token — the request
        retires at the next round boundary with ``retire_reason=
        "deadline"`` and whatever tokens it generated; a still-QUEUED
        expired request fails without ever occupying a slot.
        :meth:`cancel` retires the same way with ``"cancelled"``. A full
        queue follows the ``overload`` policy. ``_resume_tokens`` are a
        restored or migrated request's emitted tokens (:meth:`restore`);
        ``_trace`` is the fleet trace context ``(trace_id, hop)`` a
        :class:`~.fleet.FleetRouter` threads through its placements.

        A draining engine refuses new submits (a resumed one still lands:
        work folds INTO a stopping engine, never out through its
        admission); a decode-role engine refuses every submit — packages
        reach it through :meth:`admit_handoff`."""
        self._check_open()
        if self.draining and not _resume_tokens:
            raise MXNetError(
                "InferenceEngine: engine %s is draining — submit to "
                "another replica" % self.engine_id)
        if self.role == "decode":
            raise MXNetError(
                "InferenceEngine: engine %s has role='decode' — prompts go "
                "to a prefill or unified replica (the FleetRouter's "
                "role-aware placement does this)" % self.engine_id)
        # validation runs BEFORE the overload branch, so that an
        # inadmissible submit can never shed valid queued work
        try:
            prompt = np.asarray(prompt)
        except (TypeError, ValueError) as e:
            raise MXNetError(
                "InferenceEngine: prompt is not array-like (%s)" % e)
        if prompt.ndim != 1:
            raise MXNetError(
                "InferenceEngine: prompt must be a 1-D token sequence "
                "(one request per submit), got shape %r" % (prompt.shape,))
        if prompt.size < 1:
            raise MXNetError("InferenceEngine: empty prompt")
        if not np.issubdtype(prompt.dtype, np.integer):
            raise MXNetError(
                "InferenceEngine: prompt token ids must be integers, got "
                "dtype %s" % prompt.dtype)
        prompt = prompt.astype(np.int64)
        if prompt.size + len(_resume_tokens) > self.max_len - 1:
            raise MXNetError(
                "InferenceEngine: prompt length %d leaves no room to "
                "generate (max_len=%d)" % (prompt.size, self.max_len))
        if not self.prefill_chunk and not _resume_tokens:
            # whole-prompt prefill must fit one bucket program; chunked
            # engines serve any prompt <= max_len - 1 in pieces, and a
            # resumed sequence admits in bucket-sized pieces (restore()
            # never rejects what the crashed engine had accepted)
            self._bucket_for(prompt.size)
        max_tokens = int(max_tokens)
        if max_tokens < 1:
            raise MXNetError("InferenceEngine: max_tokens must be >= 1")
        if eos_id is not None:
            try:
                e = np.asarray(eos_id)
            except (TypeError, ValueError):
                e = None
            if e is None or e.ndim != 0 \
                    or not np.issubdtype(e.dtype, np.integer):
                raise MXNetError(
                    "InferenceEngine: eos_id must be a scalar integer "
                    "token id, got %r" % (eos_id,))
            eos_id = int(e)
            if eos_id < 0:
                raise MXNetError(
                    "InferenceEngine: eos_id must be >= 0, got %d "
                    "(negative ids collide with the engine's 'no eos' "
                    "sentinel)" % eos_id)
        try:
            temp = float(temperature)
        except (TypeError, ValueError):
            temp = float("nan")          # rejected just below
        if math.isnan(temp) or math.isinf(temp) or temp < 0:
            raise MXNetError(
                "InferenceEngine: temperature must be a finite float >= 0, "
                "got %r (0 = greedy)" % (temperature,))
        if self.queued() >= self.max_queue:
            if self.overload == "shed_oldest" and self._shed_oldest():
                pass                     # room made; admit the new one
            elif self.overload in ("shed", "shed_oldest"):
                _TM_SHED.inc()
                self.stats["shed"] += 1
                raise EngineOverloaded(
                    "InferenceEngine: overloaded — %d requests waiting "
                    "(max_queue=%d, overload=%r); retry against "
                    "another replica or back off"
                    % (self.queued(), self.max_queue, self.overload))
            else:
                raise MXNetError(
                    "InferenceEngine: request queue is full (%d waiting; "
                    "max_queue=%d) — step() the engine to drain it"
                    % (self.queued(), self.max_queue))
        if seed is None:
            seed = self._auto_seed
            self._auto_seed += 1
        rid = request_id
        if rid is None:
            rid = self._next_id
            self._next_id += 1
        req = Request(rid, prompt, max_tokens, eos_id, temp, int(seed),
                      min(max_tokens, self.max_len - prompt.size),
                      deadline_ms=deadline_ms,
                      ttft_deadline_ms=ttft_deadline_ms,
                      resume_tokens=_resume_tokens)
        if _trace is not None:
            req.trace = (str(_trace[0]), int(_trace[1]))
        self._pending.append(req)
        self._active[rid] = req
        if req._deadline is not None or req._ttft_deadline is not None:
            self._watched.add(rid)
        self.stats["submitted"] += 1
        self.capture.submit(req)
        if self.flight.enabled:
            meta = {"prompt_len": int(prompt.size),
                    "max_tokens": max_tokens}
            if temp:
                meta["temperature"] = temp
            if req.resumed:
                meta["resumed"] = req.resumed
            if deadline_ms is not None:
                meta["deadline_ms"] = deadline_ms
            if ttft_deadline_ms is not None:
                meta["ttft_deadline_ms"] = ttft_deadline_ms
            if req.trace is not None:
                meta["trace"], meta["hop"] = req.trace
            self.flight.start(rid, **meta)
        return req

    def cancel(self, request_id):
        """Cancel a queued or in-flight request: it retires at the next
        round boundary with ``retire_reason="cancelled"`` and whatever
        tokens already drained (``result()`` returns them); a still-queued
        request never occupies a slot. Returns True if the request was
        live, False if unknown or already done."""
        req = self._active.get(request_id)
        if req is None or req.done:
            return False
        req._cancelled = True
        self._watched.add(request_id)
        return True

    # -- KV handoff scheduler seams (the JAX package's l.2076-2315) ------
    def _handoff_prefill(self, req, slot, t, now):
        """Prefill-role drain tail: the first token lands on the request
        as unified serving would land it (TTFT is served here), then the
        finished prefill is packaged for the router. The slot leaves the
        free list into ``_handoff_slots`` — its rows must survive until
        the package resolves — and the request retires locally with
        ``retire_reason="handoff"`` (the FleetRequest treats that as still
        running). A resumed request's first token is its first recorded
        one, checked and not emitted again; the package then carries the
        rest for the decode engine to regenerate."""
        self._push_token(req, slot, t, now)
        if req.done or req.t_admit is None:
            return      # finished here (eos, a one-token budget: the slot
            # is free again), or a recorded token differed and the request
            # was queued to prefill again
        pkg = KVHandoff(self, req, slot, req._prefilled)
        self._handoff_slots.add(slot)
        self._handoff_out.append(pkg)
        self.stats["handoffs_out"] += 1
        self.flight.event(req.id, "handoff_export", slot=slot,
                          prefill_len=pkg.prefill_len)
        self._finish(req, "handoff")

    def take_handoffs(self):
        """Drain the packaged finished prefills (router-facing). The caller
        OWNS delivery: every returned package must eventually be
        ``resolve()``\\ d — delivered, deduped, or abandoned — or its slot
        stays pinned."""
        out = []
        while self._handoff_out:
            out.append(self._handoff_out.popleft())
        return out

    def _resolve_handoff(self, pkg):
        """Release a package's slot, exactly once (``KVHandoff.resolve``);
        a second resolution is a transport bug and raises."""
        if pkg.resolved:
            raise MXNetError(
                "InferenceEngine: handoff package %r resolved twice — each "
                "package has exactly one terminal path" % (pkg,))
        pkg.resolved = True
        if pkg.slot in self._handoff_slots:
            self._handoff_slots.discard(pkg.slot)
            self._release_slot(pkg.slot)

    def set_role(self, role):
        """Widen a specialist to ``"unified"`` (failover promotion: the
        survivor of a dead prefill/decode pair serves both phases; a
        program family it lacks is built at first use). Narrowing a live
        engine is refused."""
        if role == self.role:
            return
        if role != "unified":
            raise MXNetError(
                "InferenceEngine: role can only widen to 'unified' (engine "
                "%s is %r, asked for %r) — build a new engine to "
                "specialize" % (self.engine_id, self.role, role))
        self.role = "unified"
        _TM_ROLE.set(0)

    def admit_handoff(self, payload, deadline_ms=None,
                      ttft_deadline_ms=None):
        """Admit a handed-off finished prefill (router-facing): write the
        transferred KV rows into a free slot through the import program —
        or, when ``payload["rows"]`` is None because this engine's prefix
        pool retains the whole prefill, copy them out of the pool — set
        the slot's state to resume after the prefill (position ``P``, the
        token there pending, the request's draws from its seed), and
        decode on byte-identically to a unified engine.

        The payload's tokens past position ``P`` are recorded ones the
        decode rounds regenerate and check without emitting again (a
        resumed request prefilled on a prefill specialist); a payload
        whose rows cover everything but the last token has none.

        Exactly-once under retries: a package id already active or already
        imported returns the existing request without touching the cache.
        Raises :class:`EngineOverloaded` when no slot is free (the router
        tries the next decode replica or waits)."""
        self._check_open()
        if self.role == "prefill":
            raise MXNetError(
                "InferenceEngine: engine %s has role='prefill' — it exports "
                "handoffs, it cannot admit one" % self.engine_id)
        if self._windowed:
            raise MXNetError(
                "InferenceEngine: engine %s serves a windowed-ring decoder "
                "— ring rows live at wrapped positions, outside the [0, P) "
                "prefix rows a KV handoff carries" % self.engine_id)
        rid = payload["id"]
        existing = self._active.get(rid)
        if existing is None:
            existing = self._imported.get(rid)
        if existing is not None:
            return existing
        # flush every dispatched-but-undrained round BEFORE touching a
        # slot: those rounds saw the slot dead and must not drain into the
        # imported request; draining may also free slots
        while self._drain:
            self._drain_one()
        if not self._free:
            raise EngineOverloaded(
                "InferenceEngine: engine %s has no free slot for a handoff "
                "(slots=%d busy)" % (self.engine_id, self.slots))
        prompt = np.asarray(payload["prompt"], np.int64)
        tokens = [int(t) for t in payload["tokens"]]
        if not tokens:
            raise MXNetError(
                "InferenceEngine: handoff payload %r carries no first token "
                "— the prefill side emits it" % (rid,))
        req = Request(rid, prompt, int(payload["max_tokens"]),
                      payload["eos_id"], float(payload["temperature"]),
                      int(payload["seed"]),
                      min(int(payload["max_tokens"]),
                          self.max_len - prompt.size),
                      deadline_ms=deadline_ms,
                      ttft_deadline_ms=ttft_deadline_ms,
                      resume_tokens=tokens)
        # TTFT was served on the prefill engine
        req.t_first = req.t_submit
        trace = payload.get("trace")
        if trace is not None:
            # the wire crossing is one hop
            req.trace = (str(trace[0]), int(trace[1]) + 1)
        P = int(payload["prefill_len"])
        if not prompt.size <= P < len(req.seq):
            raise MXNetError(
                "InferenceEngine: handoff payload %r is inconsistent — "
                "prefill_len=%d but the prompt has %d positions and "
                "prompt+tokens %d" % (rid, P, prompt.size, len(req.seq)))
        if P > self.prefill_buckets[-1] or payload["last"] >= self.max_len:
            raise MXNetError(
                "InferenceEngine: handoff %r does not fit this engine's "
                "geometry (prefill_len=%d, last=%d vs buckets %r, "
                "max_len=%d) — replicas in one fleet share geometry"
                % (rid, P, payload["last"], self.prefill_buckets,
                   self.max_len))
        # the recorded tokens after the pending one are regenerated
        req._replay = len(req.seq) - 1 - P
        slot = self._free.popleft()
        req.t_admit = time.perf_counter()
        rows = payload.get("rows")
        entry = None
        try:
            if rows is None:
                # transfer skipped on prefix affinity: this engine's pool
                # retains the whole prefill; the pin brackets the copy
                if self._prefix is None:
                    raise MXNetError(
                        "InferenceEngine: rows-less handoff %r but engine "
                        "%s has no prefix pool" % (rid, self.engine_id))
                depth, entry = self._prefix.lookup(req.seq[:P])
                if depth < P or entry is None:
                    raise MXNetError(
                        "InferenceEngine: rows-less handoff %r but the pool "
                        "covers only %d of %d prefill positions — the "
                        "router's affinity probe was stale; retry with rows"
                        % (rid, depth, P))
                self._prefix.acquire(entry)
                self._dispatch_copy(P, src=entry.slot, dst=slot,
                                    src_pool=True, dst_pool=False)
                self._prefix.release(entry)
                entry = None
                self.stats["prefix_hits"] += 1
                self.stats["prefix_hit_tokens"] += P
                _TM_PREFIX_HITS.inc()
                _TM_PREFIX_HIT_TOKENS.inc(P)
            else:
                self._import_rows(slot, P, rows)
            self._set_slot_state(
                slot, P, int(req.seq[P]), req.temperature, req.seed,
                -1 if req.eos_id is None else req.eos_id,
                int(payload["last"]))
        except Exception:
            if entry is not None:
                self._prefix.release(entry)
            self._release_slot(slot)
            self._free.remove(slot)      # back at the head, FIFO order
            self._free.appendleft(slot)
            raise
        self._mirror[slot] = req
        self._active[rid] = req
        if req._deadline is not None or req._ttft_deadline is not None:
            self._watched.add(rid)
        if self.spec_draft == "ngram":
            # the context a unified engine's drafter has at this point:
            # what was prefilled, then the pending token
            self._drafters[rid] = NgramDrafter(req.seq[:P + 1])
        elif self.spec_draft == "model":
            self._draft_prefill_all(req, slot, req.seq[:P])
            self._draft_pending[slot] = [int(req.seq[P])]
        # decode-side retention: park the prefill in THIS engine's pool so
        # that the next same-prefix handoff ships no rows at all
        if rows is not None and self._prefix is not None \
                and not self._pressure \
                and self._prefix.get(req.seq[:P]) is None:
            try:
                new = self._prefix.insert(req.seq[:P])
                if new is not None:
                    try:
                        self._dispatch_copy(P, src=slot, dst=new.slot,
                                            src_pool=False, dst_pool=True)
                    except Exception:
                        self._prefix.discard(new)
                        raise
                _TM_PREFIX_BYTES.set(self._prefix.bytes_used)
            except Exception:            # noqa: BLE001 — isolated
                _TM_PREFIX_INSERT_SKIPPED.inc()
        self.stats["handoffs_in"] += 1
        self.stats["submitted"] += 1
        self.capture.submit(req)
        if self.flight.enabled:
            meta = {"prompt_len": int(prompt.size),
                    "max_tokens": int(payload["max_tokens"]),
                    "handoff": True, "resumed": req.resumed}
            if req.trace is not None:
                meta["trace"], meta["hop"] = req.trace
            self.flight.start(rid, **meta)
            self.flight.event(rid, "handoff_import", slot=slot,
                              prefill_len=P, rows=rows is not None)
        self._imported[rid] = req
        while len(self._imported) > 256:
            self._imported.popitem(last=False)
        return req

    # -- host-side retirement (the JAX package's l.2318-2459) -------------
    def _check_open(self):
        if self._closed:
            raise EngineClosed(
                "InferenceEngine is closed — build a new engine (or "
                "restore() a snapshot)")

    def _release_slot(self, slot):
        """Host-side slot release — the freeze contract device retirement
        uses: the card may still be decoding the slot (its request keeps
        going harmlessly until its own budget, or until the next
        occupant's prefill overwrites the slot's state and rows), and
        drain entries for it drop their tokens through the cleared
        mirror. The slot's draft-model backlog goes with it. No device
        op, no new program."""
        self._mirror[slot] = None
        if self._draft_dec is not None:
            self._draft_pending[slot] = []
        self._free.append(slot)

    def _finish(self, req, reason, error=None):
        """Common retirement tail for every host-side path; the request is
        handed back by the next ``step()`` return."""
        req.done = True
        req.t_done = time.perf_counter()
        req.retire_reason = reason
        req.error = error
        self._active.pop(req.id, None)
        self._watched.discard(req.id)
        self._drafters.pop(req.id, None)
        if self.flight.enabled:
            extra = {"tokens": len(req.tokens)}
            if error is not None:
                extra["error"] = str(error)
            self.flight.retire(req.id, reason, **extra)
        # a TTFT SLO cannot be attained by a request that died without a
        # first token: a deadline retirement counts as a miss
        if self.slo_ttft_ms is not None and req.t_first is None \
                and reason == "deadline":
            _TM_SLO_TTFT_MISS.inc()
        self.capture.retire(req)
        if reason == "deadline":
            _TM_DEADLINE.inc()
            self.stats["deadline_missed"] += 1
        elif reason == "cancelled":
            _TM_CANCELLED.inc()
            self.stats["cancelled"] += 1
        elif reason == "shed":
            _TM_SHED.inc()
            self.stats["shed"] += 1
        elif reason == "error":
            _TM_ERRORS.inc()
            self.stats["errors"] += 1
        self._done_buf.append(req)

    def _retire_active(self, req, reason, error=None):
        """Detach ``req`` from whichever scheduler structure holds it
        (queue, stager, held buffer, chunking queue, drain queue or a
        decoding slot), releasing its slot and prefix-cache pin: pins are
        released on EVERY path (a leaked pin would starve the pool)."""
        try:
            self._pending.remove(req)
        except ValueError:
            pass
        self._stager.prune(lambda item: item[0] is req)
        if self._held is not None and self._held[0] is req:
            self._held = None
        for st in list(self._chunking):
            if st["req"] is req:
                self._chunking.remove(st)
                if st["entry"] is not None:
                    self._prefix.release(st["entry"])
                    st["entry"] = None
                self._release_slot(st["slot"])
        for entry in self._drain:
            if entry[0] == "prefill" and entry[1] is req:
                # the first token is dropped at drain time (the request is
                # done); the slot frees NOW — FIFO draining keeps any
                # reuse ordered behind this entry
                self._release_slot(entry[2])
        for s in range(self.slots):
            if self._mirror[s] is req:
                self._release_slot(s)
        self._finish(req, reason, error)

    def _shed_oldest(self, why="under overload='shed_oldest' (newer "
                                "work displaced it)"):
        """Evict the oldest QUEUED (never admitted) request to make room
        (``overload="shed_oldest"``) or to drop an unadmitted backlog
        (``why`` names the cause on the victim's error). Admitted work is
        never shed. Age order: the held admission candidate, then staged
        items, then the pending deque. Returns True if one was shed."""
        victim = None
        if self._held is not None:
            victim = self._held[0]
        elif self._stager.staged():
            first = []

            def oldest(item):       # one-shot: prune is single-pass
                if first:
                    return False
                first.append(item)
                return True

            dropped = self._stager.prune(oldest)
            if dropped:
                victim = dropped[0][0]
        if victim is None and self._pending:
            victim = self._pending[0]
        if victim is None:
            return False
        self._retire_active(victim, "shed", EngineOverloaded(
            "InferenceEngine: request %r shed %s" % (victim.id, why)))
        return True

    def _sweep(self):
        """Round-boundary lifecycle sweep: retire cancelled and
        deadline-expired requests. Only ``_watched`` ids are visited, so
        deadline-less traffic pays nothing."""
        if not self._watched:
            return
        now = time.perf_counter()
        for rid in list(self._watched):
            req = self._active.get(rid)
            if req is None or req.done:
                self._watched.discard(rid)
                continue
            if req._cancelled:
                self._retire_active(req, "cancelled")
            elif req._expired(now):
                self._retire_active(req, "deadline")

    @property
    def _pressure(self):
        """Overloaded right now? Under a shedding policy this pauses
        prefix-cache retention (the slot -> pool copy competes with
        serving work exactly when there is least room for it)."""
        return self.overload != "block" \
            and self.queued() >= self.max_queue

    def _poison(self, st, exc):
        """A per-request host-side failure (bad staging, chunk math, copy
        dispatch) retires ONLY that request: its slot is released, its
        prefix pin dropped, the error carried on the request."""
        if st["entry"] is not None:
            self._prefix.release(st["entry"])
            st["entry"] = None
        self._release_slot(st["slot"])
        req = st["req"]
        self._finish(req, "error", MXNetError(
            "InferenceEngine: request %r poisoned during admission/"
            "prefill (%s: %s) — retired alone, engine keeps serving"
            % (req.id, type(exc).__name__, exc)))

    # -- the compiled programs ------------------------------------------
    @property
    def compile_counts(self):
        """``{'decode': n, 'verify': n, 'prefill': {bucket: n}, 'copy':
        {bucket: n}}``, the JAX package's compile-count contract: after
        any workload one decode program, at most one verify program (0
        with speculation off or never fired), one prefill program per
        USED bucket (chunk pieces reuse them: the start is an operand)
        and one copy program per USED bucket (both directions). Engines
        with ``draft="model"`` also report ``'draft'`` (at most 1) and
        ``'draft_prefill'`` ({bucket: 1}). Engines that ever touched the
        KV handoff path (``role`` not ``"unified"``, or a unified engine
        that imported) also report ``'handoff'`` ({bucket: 1}: one row
        mover a bucket; an engine moves rows one way only). On the card a
        count is a capture; on the CPU, a program's first run."""
        out = {"decode": 0, "verify": 0, "prefill": {}, "copy": {}}
        if self.spec_draft == "model":
            out["draft"] = 0
            out["draft_prefill"] = {}
        if self.role != "unified" or any(
                t[0] == "handoff" for t in self._compile_log
                if not isinstance(t, str)):
            out["handoff"] = {}
        for tag in self._compile_log:
            if isinstance(tag, str):
                out[tag] += 1
            else:
                fam = out[tag[0]]
                fam[tag[1]] = fam.get(tag[1], 0) + 1
        return out

    def _state(self):
        return (self._pos, self._tok, self._live, self._eos, self._last,
                self._temp, self._uniform)

    def _operand(self, *shape):
        return torch.zeros(shape, dtype=torch.int64, device=self.device)

    def _program(self, tag):
        """The program of ``tag``, built at its first use: ``"decode"``,
        ``"verify"``, ``"draft"``, or ``(family, bucket)`` for the
        ``"prefill"``, ``"copy"`` and ``"draft_prefill"`` families."""
        prog = self._programs.get(tag)
        if prog is not None:
            return prog
        S, K = self.slots, self.spec_k
        if tag == "decode":
            fn, operands = self._decode_fn, {}
        elif tag == "verify":
            operands = {"drafts": self._operand(S, K),
                        "dlen": self._operand(S)}
            fn = functools.partial(self._verify_fn, **operands)
        elif tag == "draft":
            operands = {"pos": torch.zeros((S,), dtype=torch.int32,
                                           device=self.device),
                        "catchup": self._operand(S, K + 1),
                        "clen": self._operand(S)}
            fn = functools.partial(self._draft_fn, **operands)
        else:
            family, bucket = tag
            n = {"prefill": bucket + _N_SCALARS, "copy": 2,
                 "draft_prefill": bucket + _N_DRAFT_SCALARS}[family]
            operands = {"ops": self._operand(n)}
            fn = functools.partial(
                {"prefill": self._prefill_fn, "copy": self._copy_fn,
                 "draft_prefill": self._draft_prefill_fn}[family],
                bucket, operands["ops"])
        stats = "serving_" + (tag if isinstance(tag, str)
                              else "%s_b%d" % tag)
        prog = self._programs[tag] = Program(
            fn, operands, mutable=self._state(),
            name="InferenceEngine %s program" % (tag,), tag=tag,
            log=self._compile_log, device=self.device, stats=stats)
        return prog

    # -- KV handoff row movers (the JAX package's l.1711-1788) ------------
    def _handoff_rows(self, bucket):
        """The staging allocations of ``bucket``'s row movers, made at
        first use and kept (the programs read and write them in place):
        grouped as the cache is, ``[count, 1, bucket, ...]`` each."""
        stage = self._handoff_stage.get(bucket)
        if stage is None:
            stage = self._handoff_stage[bucket] = _grouped_cache(
                self._caches, 1, bucket)[0]
        return stage

    def _handoff_program(self, bucket, write):
        """The row mover of ``bucket`` and direction: export (``write``
        False) gathers the first ``bucket`` rows of slot ``ops[0]`` into
        the staging buffers, reading the cache and writing nothing of it
        (other slots keep decoding against it); import writes the staging
        buffers into rows ``[0, bucket)`` of the slot. Both are tagged
        ``("handoff", bucket)``."""
        key = ("handoff", bucket, bool(write))
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        stage = self._handoff_rows(bucket)
        ops = self._operand(1)

        def export():
            for g, sg in zip(self._groups, stage):
                torch.index_select(_wide(g)[:, :, :bucket], 1, ops,
                                   out=_wide(sg))

        def write_rows():
            for g, sg in zip(self._groups, stage):
                _wide(g)[:, :, :bucket].index_copy_(1, ops, _wide(sg))

        prog = self._programs[key] = Program(
            write_rows if write else export, {"ops": ops},
            mutable=self._state(),
            name="InferenceEngine handoff %s program (bucket %d)"
            % ("import" if write else "export", bucket),
            tag=("handoff", bucket), log=self._compile_log,
            device=self.device, stats="serving_handoff%s_b%d"
            % ("_wr" if write else "", bucket))
        return prog

    def _export_rows(self, slot, length):
        """One slot's first ``length`` KV rows (rounded up to the covering
        bucket: the decode side's mask hides the pad rows until they are
        overwritten) as a row tree of host tensors, through the export
        program and one device-to-host copy an allocation. Under tp the
        ranks' rows are put back together on the head axis, as the JAX
        export's global array has them: a package does not depend on the
        degree of the engine that made it."""
        bucket = self._bucket_for(length)
        tc0 = time.perf_counter()
        with tele.span("serving.handoff_export", cat="serving",
                       bucket=bucket):
            self._handoff_program(bucket, False)(ops=np.array([slot]))
            stage = self._handoff_rows(bucket)
            host = [sg.cpu() for sg in stage]
        self._phase_add("copy", time.perf_counter() - tc0)
        rows = _unflatten(self._caches, [
            host[g][i] for g, i in _group_layout(self._caches)[2]])
        if self.tp == 1:
            return rows
        return [tuple(torch.cat(parts, dim=2) for parts in zip(*entries))
                for entries in zip(*rows)]

    def _import_rows(self, slot, length, rows):
        """Write transferred rows into ``slot``: dequantized to the cache
        dtype first (an int8 transfer), cut into the ranks' head blocks
        under tp, each allocation's rows copied into the staging buffers,
        then the import program."""
        bucket = self._bucket_for(length)
        ranks = rank_trees(self._caches)
        rows = unpack_rows(rows, ranks[0])
        if self.tp > 1:
            rows = [[tuple(r.chunk(self.tp, dim=2)[k] for r in e)
                     for e in rows] for k in range(self.tp)]
        stage = self._handoff_rows(bucket)
        _, counts, where = _group_layout(self._caches)
        parts = [[None] * n for n in counts]
        for (g, i), r in zip(where, _leaves(rows)):
            parts[g][i] = r[0]
        tc0 = time.perf_counter()
        with tele.span("serving.handoff_import", cat="serving",
                       bucket=bucket):
            for sg, ps in zip(stage, parts):
                copy_in(sg, torch.stack(ps)[:, None])
            self._handoff_program(bucket, True)(ops=np.array([slot]))
        self._phase_add("copy", time.perf_counter() - tc0)

    def _set_slot_state(self, slot, pos, tok, temperature, seed, eos, last):
        """Make ``slot`` live at ``pos`` with ``tok`` pending and the
        request's sampling identity, as the final prefill piece leaves a
        slot (the draws of every position from the seed, computed the
        prefill program's way): the handoff's admission, which runs no
        prefill. Eager, in place, on the stream the programs replay on."""
        dev = self.device
        idx = torch.tensor([slot], dtype=torch.int64, device=dev)
        seed = (int(seed) + 2 ** 63) % 2 ** 64 - 2 ** 63    # as int64
        draws = uniform_draw(
            torch.tensor([seed], dtype=torch.int64, device=dev),
            torch.arange(self.max_len, device=dev))
        for buf, val in ((self._pos, pos), (self._tok, tok),
                         (self._live, True), (self._eos, eos),
                         (self._last, last),
                         (self._temp, np.float32(temperature))):
            buf.index_copy_(0, idx, torch.tensor([val], dtype=buf.dtype,
                                                 device=dev))
        self._uniform.index_copy_(0, idx, draws[None])

    def _staged_run(self, dec, params, aux, groups, stage_groups, stage,
                    slot, start, tokens, true_len, ep=None):
        """One prefill piece of ``tokens`` [1, bucket] at ``start`` (its
        first ``true_len`` tokens real) into ``slot`` of the cache
        allocations ``groups``, run over the staging cache ``stage``
        (allocations ``stage_groups``): the gather-in (the slot's rows
        ``[0, max_len)`` copied into the staging rows, so that a piece at
        ``start > 0`` sees the rows earlier pieces or a prefix copy left
        there; in a graph the copy has a fixed shape, all ``max_len`` rows,
        one kernel an allocation), the walk, then the piece's rows
        ``[start, start + bucket)`` written back to the slot (those past
        ``max_len`` are pad rows and are not). A windowed node's ring is
        not addressed by absolute row: its allocations (the ring and its
        positions) go in and come back whole, the positions are wiped on a
        request's first piece (``start == 0``: the slot's last occupant's
        rows must not show), and the walk writes only the piece's real rows
        into the ring (``valid_len``), as the JAX program does. ``ep``: the
        walk's (the target's, never the draft model's). Returns the logits
        [1, bucket, V]."""
        n = self.max_len
        rings = [key[3] is not None for key in _group_layout(stage)[0]]
        for g, sg, ring in zip(groups, stage_groups, rings):
            torch.index_select(_wide(g), 1, slot,
                               out=_wide(sg) if ring else _wide(sg)[:, :, :n])
        if any(rings):
            dec.clear_window_positions(stage, only_if=start == 0)
        logits, _ = dec._run(params, aux, stage, start.to(torch.int32),
                             tokens, valid_len=start + true_len,
                             tp=self._tp_ax, mm_impl=self.matmul_impl, ep=ep)
        rows = (start + torch.arange(tokens.shape[1], device=start.device)
                ).clamp_max(n - 1)
        for g, sg, ring in zip(groups, stage_groups, rings):
            if ring:
                _wide(g).index_copy_(1, slot, _wide(sg))
                continue
            # [slots, rows, count, ...] views: one index_put_ an allocation
            _wide(g).transpose(0, 1).transpose(1, 2).index_put_(
                (slot.expand(rows.shape[0]), rows),
                _wide(sg)[:, 0].index_select(1, rows).transpose(0, 1))
        return logits

    def _prefill_fn(self, bucket, ops):
        """The prefill program of ``bucket``, for whole prompts and every
        chunk piece: ``ops`` holds the padded piece, then the slot, the
        chunk start, the piece's true length, final, the temperature's
        float32 bits, the seed, the EOS id (-1: none) and the token
        budget. The piece runs over the staging cache (:meth:`_staged_run`)
        and the slot's state is set as the JAX program sets it: a final
        piece picks the first token at the last real position and makes
        the slot live; a non-final one parks the slot dead at (pos =
        prompt covered so far, tok = the piece's last token), which the
        decode rounds in between rewrite in place at a row the next piece
        overwrites. Returns the picked token [1]."""
        slot, start, true_len, final, tbits, seed, eos, max_toks = (
            ops[bucket + i:bucket + i + 1] for i in range(_N_SCALARS))
        temp = tbits.to(torch.int32).view(torch.float32)
        logits = self._staged_run(self._dec, self._params, self._aux,
                                  self._groups, self._stage_groups,
                                  self._stage, slot, start,
                                  ops[None, :bucket], true_len,
                                  ep=self._ep_ax)
        total = start + true_len
        lastp = (total + max_toks - 1).clamp_max(self.max_len - 1)
        draws = uniform_draw(seed, torch.arange(self.max_len,
                                                device=ops.device))
        t0 = sample_tokens(logits[0].index_select(0, true_len - 1), temp,
                           draws.index_select(0, total))
        final = final != 0
        head = torch.where(final, t0, ops.index_select(0, true_len - 1))
        live = final & (t0 != eos) & (total < lastp)
        for buf, val in ((self._pos, total), (self._tok, head),
                         (self._live, live), (self._eos, eos),
                         (self._last, lastp), (self._temp, temp),
                         (self._uniform, draws[None])):
            buf.index_copy_(0, slot, val.to(buf.dtype))
        return t0

    def _copy_fn(self, bucket, ops):
        """The prefix-copy program of ``bucket``: rows ``[0, bucket)`` of
        slot ``ops[0]`` of the cache into slot ``ops[1]`` (slot ``S + i``
        is pool slot ``i``), every buffer, row scales included: the
        ``Decoder.slot_prefix_rows`` / ``slot_write_prefix_rows`` pair over
        each allocation at once."""
        for g in self._groups:
            head = _wide(g)[:, :, :bucket]
            head.index_copy_(1, ops[1:2], head.index_select(1, ops[0:1]))

    def _decode_fn(self):
        """The decode program: ``steps_per_round`` steps over every slot.
        Each writes its pending token at its own position and picks the
        next one; finished slots stay frozen, rewriting their last token
        in place. The state vectors are updated in place. Returns the
        [steps, S] tokens (-1 where a slot had none)."""
        dec = self._dec
        outs = []
        for _ in range(self.steps_per_round):
            logits, _ = dec._run_slots(
                self._params, self._aux, self._caches, self._pos,
                self._tok[:, None], impl=self.attn_impl, tp=self._tp_ax,
                mm_impl=self.matmul_impl, ep=self._ep_ax)
            nxt_pos = self._pos + 1
            # a frozen slot at the cache's end draws from its last row
            u = self._uniform.gather(
                1, nxt_pos.clamp_max(self.max_len - 1).long()[:, None])
            nxt = sample_tokens(logits[:, 0], self._temp, u[:, 0])
            done_now = (nxt == self._eos) | (nxt_pos >= self._last)
            outs.append(torch.where(self._live, nxt,
                                    torch.full_like(nxt, -1)))
            self._pos.copy_(torch.where(self._live, nxt_pos, self._pos))
            self._tok.copy_(torch.where(self._live, nxt, self._tok))
            self._live.copy_(self._live & ~done_now)
        return torch.stack(outs)

    def _verify_fn(self, drafts, dlen):
        """The verify program (``Decoder.verify_step_slots``): each slot's
        chunk ``[tok, drafts]`` scored in one run, its accepted prefix and
        one corrected token emitted; the state vectors are updated in
        place. Returns the [K+1, S] tokens (-1 where none)."""
        _, st, out = self._dec.verify_step_slots(
            self._params, self._aux, self._caches,
            (self._pos, self._tok, self._live, self._temp, self._uniform,
             self._eos, self._last), drafts, dlen, impl=self.attn_impl,
            tp=self._tp_ax, mm_impl=self.matmul_impl, ep=self._ep_ax)
        for buf, val in zip((self._pos, self._tok, self._live), st):
            buf.copy_(val)
        return out

    def _draft_fn(self, pos, catchup, clen):
        """The draft program (``Decoder.draft_propose_slots``): the draft
        cache catches up on what the target emitted, then proposes
        ``spec_k`` greedy tokens a slot. Returns the [S, K] drafts."""
        _, props = self._draft_dec.draft_propose_slots(
            self._draft_params, self._draft_aux, self._draft_caches, pos,
            catchup, clen, self.spec_k, impl=self.attn_impl,
            tp=self._tp_ax, mm_impl=self.matmul_impl)
        return props

    def _draft_prefill_fn(self, bucket, ops):
        """The draft model's prefill program of ``bucket``: the padded
        piece's K/V into the slot (``ops``: the piece, then the slot, the
        start and the piece's true length) of the draft cache, through its own
        staging cache. No sampling and no state: the draft program decodes
        from this cache."""
        slot, start, true_len = (ops[bucket + i:bucket + i + 1]
                                 for i in range(_N_DRAFT_SCALARS))
        self._staged_run(self._draft_dec, self._draft_params,
                         self._draft_aux, self._draft_groups,
                         self._draft_stage_groups, self._draft_stage, slot,
                         start, ops[None, :bucket], true_len)

    # -- admission --------------------------------------------------------
    def _suffix_cost(self, n):
        """Prefill work of an ``n``-token suffix: the padded tokens of its
        pieces (what bucket quantization charges for), split as
        :meth:`_advance_chunk` splits it (with chunking off, pieces of the
        largest bucket: a resumed sequence can exceed it)."""
        chunk = self.prefill_chunk or self.prefill_buckets[-1]
        total = 0
        while n > 0:
            piece = min(n, chunk)
            total += self._bucket_for(piece)
            n -= piece
        return total

    def _dispatch_copy(self, length, src, dst, src_pool, dst_pool):
        """Run the copy program of ``length``'s bucket: a prefix hit's
        pool -> slot copy or a retention's slot -> pool copy."""
        bucket = self._bucket_for(length)
        S = self.slots
        tc0 = time.perf_counter()
        with tele.span("serving.prefix_copy", cat="serving",
                       bucket=bucket, to_pool=bool(dst_pool)):
            self._program(("copy", bucket))(ops=np.array(
                [src + S * bool(src_pool), dst + S * bool(dst_pool)],
                np.int64))
        self._phase_add("copy", time.perf_counter() - tc0)
        self.stats["prefix_copies"] += 1

    def _dispatched(self):
        """What the watchdog polls for the round just dispatched: a CUDA
        event recorded behind it on the current stream while the watchdog
        is armed on the card; None (ready) otherwise."""
        if self.round_timeout_ms <= 0 or self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _advance_chunk(self, st):
        """Run the next prefill piece of an admitted request: the whole
        remaining suffix when chunking is off (or it fits), else one
        ``prefill_chunk`` piece (a resumed sequence past the largest
        bucket admits in bucket-sized pieces with chunking off). A whole
        sequence staged ahead (:meth:`_place_prompt`) reaches the
        program's operand by one device-to-device copy; the scalars are
        written then. The final piece picks the first token and (prefix
        cache on) retains the prompt's K/V in the pool. Returns True once
        the final piece ran. An exception poisons only this request (the
        caller routes it to :meth:`_poison`)."""
        req, slot = st["req"], st["slot"]
        flt = _SERVING_FAULTS
        if flt is not None:
            flt.serving_h2d(req)         # injected per-request fault
        start = st["next"]
        seq = req._admitted()
        p = len(seq)
        piece = min(p - start,
                    self.prefill_chunk or self.prefill_buckets[-1])
        final = start + piece == p
        staged = st["dev"] if start == 0 and piece == p else None
        bucket = self._bucket_for(piece) if staged is None \
            else int(staged.shape[0])
        tbits = int(np.float32(req.temperature).view(np.int32))
        seed = (req.seed + 2 ** 63) % 2 ** 64 - 2 ** 63   # as int64
        scalars = np.array([slot, start, piece, final, tbits, seed,
                            -1 if req.eos_id is None else req.eos_id,
                            req.limit - (p - len(req.prompt))], np.int64)
        prog = self._program(("prefill", bucket))
        ops = prog.operands["ops"]
        tp0 = time.perf_counter()
        with tele.span("serving.prefill", cat="serving", bucket=bucket,
                       slot=slot, start=start):
            if staged is not None:
                ops[:bucket].copy_(staged)
                copy_in(ops[bucket:], scalars)
            else:
                host = np.zeros(bucket + _N_SCALARS, np.int64)
                host[:piece] = seq[start:start + piece]
                host[bucket:] = scalars
                copy_in(ops, host)
            t0 = prog.run()
        self._phase_add("prefill", time.perf_counter() - tp0)
        self.flight.event(req.id, "prefill_chunk", start=start,
                          tokens=piece, bucket=bucket, final=bool(final))
        req.prefill_chunks += 1
        st["next"] = start + piece
        self.stats["prefill_chunks"] += 1
        self._round_budget -= piece
        if not final:
            return False
        req._prefilled = p
        # the first token stays on the card until drained (a copy: the
        # next run of the program overwrites its output)
        self._drain.append(("prefill", req, slot, t0.clone(),
                            self._dispatched()))
        self.stats["prefills"] += 1
        _TM_PREFILLS.inc()
        _TM_CHUNKS.observe(req.prefill_chunks)
        if st["entry"] is not None:
            self._prefix.release(st["entry"])
            st["entry"] = None
        # a duplicate prompt admitted while this one was mid-chunk may
        # have retained the same tokens first: its rows are the same.
        # Retention is skipped under overload pressure (checked now, at
        # the dispatch), and its failures are not fatal: the request has
        # its token coming — the half-made entry is dropped
        try:
            if st["insert"] and not self._pressure \
                    and self._prefix.get(seq) is None:
                ev0 = self._prefix.evictions
                new = self._prefix.insert(seq)
                _TM_PREFIX_EVICTIONS.inc(self._prefix.evictions - ev0)
                if new is None:
                    _TM_PREFIX_INSERT_SKIPPED.inc()
                else:
                    self.flight.event(req.id, "retained", tokens=p)
                    try:
                        # the slot's rows [0, P) are the prompt's K/V now;
                        # the copy runs before any later program on the
                        # stream
                        self._dispatch_copy(p, src=slot, dst=new.slot,
                                            src_pool=False, dst_pool=True)
                    except Exception:
                        self._prefix.discard(new)
                        raise
                _TM_PREFIX_BYTES.set(self._prefix.bytes_used)
        except Exception:                # noqa: BLE001 — isolated
            _TM_PREFIX_INSERT_SKIPPED.inc()
        return True

    def _draft_prefill_all(self, req, slot, seq=None):
        """Build the draft model's cache for a freshly admitted slot: the
        whole admitted sequence (or ``seq``) in pieces of the largest
        bucket at most, at admission (the draft model is small, so its
        prefill is not budgeted, and it ignores prefix hits: the pool holds
        target K/V only). Resets the slot's draft clock and pending
        tokens."""
        if seq is None:
            seq = req._admitted()
        p = len(seq)
        start = 0
        top = self.prefill_buckets[-1]
        td0 = time.perf_counter()
        while start < p:
            piece = min(p - start, top)
            bucket = self._bucket_for(piece)
            ops = np.zeros(bucket + _N_DRAFT_SCALARS, np.int64)
            ops[:piece] = seq[start:start + piece]
            ops[bucket:] = (slot, start, piece)
            self._program(("draft_prefill", bucket))(ops=ops)
            start += piece
        self._phase_add("prefill", time.perf_counter() - td0)
        self._draft_pos[slot] = p
        self._draft_pending[slot] = []

    def _admit(self):
        """Fill free slots from the staged queue, between decode rounds: a
        prefix-cache lookup (the longest retained prefix, copied into the
        slot), then the first prefill piece of the uncovered suffix;
        further pieces run one a round (:meth:`step`). Under chunking each
        first piece draws from the round's prefill budget; a request whose
        piece does not fit is held and admitted first next round. A
        request cancelled or expired while queued, or whose staging
        failed, retires here without a slot. Returns how many requests
        were admitted."""
        admitted = 0
        now = time.perf_counter()
        while self._free:
            if self._held is not None:
                (req, dev), self._held = self._held, None
            else:
                try:
                    req, dev = self._stager.next()
                except StopIteration:
                    break
            if req.done:
                continue            # retired while staged (shed/close)
            if req._cancelled or req._expired(now):
                self._finish(req, "cancelled" if req._cancelled
                             else "deadline")
                continue
            if isinstance(dev, _PlacementError):
                self._finish(req, "error", MXNetError(
                    "InferenceEngine: request %r failed h2d staging "
                    "(%s)" % (req.id, dev.error)))
                continue
            seq = req._admitted()
            p = len(seq)
            try:
                hit, entry, depth = 0, None, 0
                if self._prefix is not None:
                    tl0 = time.perf_counter()
                    with tele.span("serving.prefix_lookup",
                                   cat="serving",
                                   hist=_TM_PREFIX_LOOKUP_MS):
                        depth, entry = self._prefix.lookup(seq)
                    self._phase_add("prefix_lookup",
                                    time.perf_counter() - tl0)
                    # a full hit still prefills the last prompt token:
                    # the pool holds K/V only, and the first token needs
                    # logits
                    hit = min(depth, p - 1)
                    # a hit must lower the prefill work, else the copy is
                    # pure overhead on the same bucketed prefill: a miss
                    if hit > 0 and self._suffix_cost(p - hit) \
                            >= self._suffix_cost(p):
                        hit, entry = 0, None
            except Exception as e:       # noqa: BLE001 — trie fault
                # poisons THIS request: no slot taken, nothing pinned
                self._finish(req, "error", MXNetError(
                    "InferenceEngine: prefix-cache lookup failed for "
                    "request %r (%s)" % (req.id, e)))
                continue
            first_piece = min(p - hit, self.prefill_chunk or p - hit)
            if first_piece > self._round_budget:
                self._held = (req, dev)
                break
            slot = self._free.popleft()
            req.t_admit = time.perf_counter()
            _TM_QUEUE_WAIT_MS.observe((req.t_admit - req.t_submit) * 1e3)
            self.flight.event(
                req.id, "admitted", slot=slot,
                queue_wait_ms=round((req.t_admit - req.t_submit) * 1e3,
                                    3))
            # retain only prompts no entry covers whole that fit the copy
            # buckets
            st = {"req": req, "slot": slot, "dev": dev, "next": hit,
                  "entry": None,
                  "insert": self._prefix is not None and depth < p
                  and p <= self.prefill_buckets[-1]}
            try:
                if self.spec_draft == "ngram":
                    # the drafter's context: what was prefilled, then
                    # every token the slot generates
                    self._drafters[req.id] = NgramDrafter(seq)
                elif self.spec_draft == "model":
                    self._draft_prefill_all(req, slot)
                if self._prefix is not None:
                    if hit > 0:
                        self._prefix.acquire(entry)
                        st["entry"] = entry
                        req.prefix_hit_tokens = hit
                        self.stats["prefix_hits"] += 1
                        self.stats["prefix_hit_tokens"] += hit
                        _TM_PREFIX_HITS.inc()
                        _TM_PREFIX_HIT_TOKENS.inc(hit)
                        self.flight.event(req.id, "prefix_hit",
                                          tokens=hit)
                        self._dispatch_copy(hit, src=entry.slot, dst=slot,
                                            src_pool=True, dst_pool=False)
                    else:
                        _TM_PREFIX_MISSES.inc()
                        self.flight.event(req.id, "prefix_miss")
                if not self._advance_chunk(st):
                    self._chunking.append(st)
            except Exception as e:       # noqa: BLE001 — poisoned
                self._poison(st, e)
            admitted += 1
        return admitted

    # -- decode rounds ------------------------------------------------------
    def _decode_round(self):
        """One run of the decode program. Returns its [steps, S] tokens,
        copied out of the program's output (up to ``drain_depth`` rounds
        wait to be drained, and the next run overwrites it)."""
        block = self._program("decode")().clone()
        self.stats["steps"] += 1
        return block

    def _spec_round(self, busy):
        """Run ONE verify round if it can: up to ``spec_k`` drafts a
        decodable slot from the drafter, then the verify program (each
        slot's accepted prefix plus one corrected token, a ``[K+1, S]``
        drain). Returns False, and the caller runs the plain decode round,
        when no slot drafted, or when any occupied slot sits too near the
        cache's end for the fixed-width chunk write (the last few tokens
        of a sequence near ``max_len`` decode plainly)."""
        K = self.spec_k
        S = self.slots
        parts = []
        for s in range(S):
            req = self._mirror[s]
            if req is None:
                continue
            # the slot's device position (exact: speculation drains
            # eagerly), and the tokens the card has generated for it
            made = len(req.tokens) - req._replay
            pos = len(req.prompt) + made - 1
            if pos + K + 2 > self.max_len:
                return False
            k_s = min(K, req.limit - made - 1)
            if k_s > 0:
                parts.append((s, req, k_s))
        for st in self._chunking:
            # slots parked mid-prefill ride the chunk write too
            if st["next"] + K + 2 > self.max_len:
                return False
        for entry in self._drain:
            # a slot admitted this round (not in the mirror yet) is live
            # at pos = len(seq) and rides the chunk write
            if entry[0] == "prefill" and not entry[1].done \
                    and len(entry[1]._admitted()) + K + 2 > self.max_len:
                return False
        if not parts:
            return False
        drafts = np.zeros((S, K), np.int64)
        dlen = np.zeros((S,), np.int64)
        if self.spec_draft == "ngram":
            for s, req, k_s in parts:
                dr = self._drafters.get(req.id)
                prop = dr.propose(k_s) if dr is not None else []
                if prop:
                    drafts[s, :len(prop)] = prop
                    dlen[s] = len(prop)
            if not dlen.any():
                return False
            _TM_SPEC_NGRAM.inc(int(dlen.sum()))
        else:
            self._model_drafts(parts, drafts, dlen)
            if not dlen.any():
                return False
            _TM_SPEC_MODEL.inc(int(dlen.sum()))
        ndraft = int(dlen.sum())
        self.stats["spec_drafted"] += ndraft
        _TM_SPEC_DRAFTED.inc(ndraft)
        tv0 = time.perf_counter()
        with tele.span("serving.verify_round", cat="serving",
                       slots_busy=busy, drafted=ndraft):
            out = self._program("verify")(drafts=drafts, dlen=dlen).clone()
            ev = self._dispatched()
        self._phase_add("dispatch", time.perf_counter() - tv0)
        self._drain.append(("verify", out, dlen, ev))
        self.stats["steps"] += 1
        self.stats["spec_rounds"] += 1
        _TM_ROUNDS.inc()
        _TM_SPEC_ROUNDS.inc()
        _TM_SLOTS_BUSY.observe(busy)
        flt = _SERVING_FAULTS
        if flt is not None:
            flt.serving_crash()      # injected mid-round process death
        return True

    def _model_drafts(self, parts, drafts, dlen):
        """Draft-model proposals: catch the draft cache up on every token
        emitted since its last run (``_push_token`` queues them), then one
        greedy ``spec_k``-token proposal a slot, all through the ONE draft
        program. A backlog longer than the catch-up width drains over
        several runs; each slot's proposal comes from the run in which its
        catch-up completed. Slots with nothing pending ride along with a
        junk write above their head."""
        K = self.spec_k
        S = self.slots
        W = K + 1
        final_props = np.zeros((S, K), np.int64)
        proposed = set()
        while True:
            pos = np.zeros((S,), np.int32)
            catchup = np.zeros((S, W), np.int64)
            clen = np.ones((S,), np.int64)
            again = False
            newly_done = []
            for s in range(S):
                pos[s] = min(self._draft_pos[s], self.max_len - W)
                pend = self._draft_pending[s]
                if pend:
                    n = min(len(pend), W)
                    catchup[s, :n] = pend[:n]
                    clen[s] = n
                    del pend[:n]
                    self._draft_pos[s] += n
                    if pend:
                        again = True
                    else:
                        newly_done.append(s)
            tdf0 = time.perf_counter()
            props = self._program("draft")(pos=pos, catchup=catchup,
                                           clen=clen)
            self._phase_add("dispatch", time.perf_counter() - tdf0)
            if newly_done:
                props = props.cpu().numpy()                  # [S, K]
                for s in newly_done:
                    final_props[s] = props[s]
                    proposed.add(s)
            if not again:
                break
        for s, req, k_s in parts:
            if s in proposed:     # else nothing pending fed the draft
                drafts[s, :k_s] = final_props[s, :k_s]
                dlen[s] = k_s

    # -- drain ----------------------------------------------------------------
    def _push_token(self, req, slot, t, now):
        if t < 0:
            raise MXNetError("InferenceEngine: drained a token from a "
                             "slot the card had retired")
        if req._replay:
            # a restored request regenerating what it had emitted
            if t != req.tokens[req.resumed - req._replay]:
                self._prefill_resumed(req, slot)
                return
            req._replay -= 1
        else:
            req.tokens.append(int(t))
        if self._spec:
            dr = self._drafters.get(req.id)
            if dr is not None:
                dr.append(t)          # the n-gram context stays current
            if self._draft_dec is not None:
                # the draft cache catches up on it before the next
                # proposal
                self._draft_pending[slot].append(int(t))
        if len(req.tokens) == req.resumed:
            return                    # regenerated, not emitted again
        if req.t_first is None:
            req.t_first = now
            ttft_ms = (now - req.t_submit) * 1e3
            _TM_TTFT_MS.observe(ttft_ms)
            if self.slo_ttft_ms is not None:
                (_TM_SLO_TTFT_OK if ttft_ms <= self.slo_ttft_ms
                 else _TM_SLO_TTFT_MISS).inc()
            self.flight.event(req.id, "first_token",
                              ttft_ms=round(ttft_ms, 3))
        else:
            self.flight.token(req.id, len(req.tokens))
        self.stats["tokens"] += 1       # serving.tokens: once an entry
        hit_eos = req.eos_id is not None and t == req.eos_id
        if hit_eos or len(req.tokens) >= req.limit:
            req.done = True
            req.t_done = now
            req.retire_reason = "eos" if hit_eos else "length"
            (_TM_RETIRED_EOS if hit_eos else _TM_RETIRED_LENGTH).inc()
            _TM_COMPLETED.inc()
            self._drafters.pop(req.id, None)
            # cadence = wall time per decode interval THIS engine ran: a
            # resumed request's earlier tokens arrived before t_first
            if len(req.tokens) - req.resumed > 1:
                cadence_ms = ((req.t_done - req.t_first)
                              / (len(req.tokens) - req.resumed - 1) * 1e3)
                _TM_CADENCE_MS.observe(cadence_ms)
                if self.slo_cadence_ms is not None:
                    (_TM_SLO_CAD_OK if cadence_ms <= self.slo_cadence_ms
                     else _TM_SLO_CAD_MISS).inc()
            self._active.pop(req.id, None)
            self._watched.discard(req.id)
            self._release_slot(slot)
            self.stats["completed"] += 1
            self.capture.retire(req)
            self.flight.retire(req.id, req.retire_reason,
                               tokens=len(req.tokens))
            self._done_buf.append(req)

    def _prefill_resumed(self, req, slot):
        """A regenerated token differs from the recorded one: this
        engine's arithmetic is not the one that emitted the request's
        tokens. Resume it as the JAX package does: release the slot (the
        card runs its copy on harmlessly) and queue the request first, to
        prefill ``seq`` = prompt + every recorded token."""
        self.flight.event(req.id, "replay_diverged",
                          at=req.resumed - req._replay)
        req._replay = 0
        req.t_admit = None
        self._drafters.pop(req.id, None)
        self._release_slot(slot)
        self._pending.appendleft(req)

    def _guard_ready(self, event):
        """Round watchdog: with ``round_timeout_ms`` set, poll the drain
        head's CUDA event (and an injected hang) before any device ->
        host copy, and raise a typed :class:`EngineStuck` instead of
        blocking on a wedged round. A finished round costs one
        ``query()``; the poll sleeps 1 ms between tries only while the
        round is not done. The undrained entry stays queued — a recovered
        device drains it on the next step."""
        if self.round_timeout_ms <= 0:
            return
        flt = _SERVING_FAULTS
        deadline = time.perf_counter() + self.round_timeout_ms / 1e3
        while True:
            stuck = flt is not None and flt.serving_round_stuck()
            if not stuck and (event is None or event.query()):
                return
            if time.perf_counter() >= deadline:
                _TM_WATCHDOG.inc()
                self.stats["watchdog_trips"] += 1
                self._watchdog_stuck_t = time.perf_counter()
                raise EngineStuck(
                    "InferenceEngine: dispatched round not ready after "
                    "round_timeout_ms=%g — device stuck or overloaded. "
                    "step() again to retry the drain, or snapshot()/"
                    "restore() onto a fresh engine"
                    % self.round_timeout_ms)
            time.sleep(0.001)

    def _phase_add(self, key, dt):
        """Attribute ``dt`` seconds of the round in flight to a phase
        (no-op outside step())."""
        acc = self._phase
        if acc is not None:
            acc[key] = acc.get(key, 0.0) + dt

    def _drain_one(self):
        t0 = time.perf_counter()
        n0 = self.stats["tokens"]
        try:
            self._drain_one_inner()
        finally:
            # one locked add an entry, not one a token
            _TM_TOKENS.inc(self.stats["tokens"] - n0)
            self._phase_add("drain", time.perf_counter() - t0)

    def _drain_one_inner(self):
        entry = self._drain[0]       # peek: a watchdog trip must not
        self._guard_ready(entry[-1])  # lose the undrained round
        self._watchdog_stuck_t = None    # drained: the device recovered
        self._drain.popleft()
        now = time.perf_counter()
        if entry[0] == "prefill":
            _, req, slot, t0, _ = entry
            if req.done:
                return               # host-retired while in flight: its
                                     # slot was already released
            if self.role == "prefill":
                self._handoff_prefill(req, slot, int(t0), now)
                return
            self._mirror[slot] = req
            self._push_token(req, slot, int(t0), now)
            return
        rows = entry[1].cpu().numpy()       # [steps, S] or [K+1, S]
        if entry[0] == "step":
            for row in rows:
                for s in range(self.slots):
                    req = self._mirror[s]
                    if req is not None:
                        self._push_token(req, s, int(row[s]), now)
            return
        # a verify round: row i is the i-th token a slot emitted, -1 where
        # its accepted prefix ended (a slot without drafts emits exactly
        # row 0, its plain-decode token); accepted drafts = emitted - 1
        dlen = entry[2]
        emitted = np.zeros((self.slots,), np.int64)
        for row in rows:
            for s in range(self.slots):
                req = self._mirror[s]
                t = int(row[s])
                if req is None or t < 0:
                    continue
                emitted[s] += 1
                self._push_token(req, s, t, now)
        acc = 0
        for s in range(self.slots):
            if dlen[s] > 0 and emitted[s] > 0:
                a = int(emitted[s]) - 1
                acc += a
                _TM_SPEC_ACCEPT_LEN.observe(a)
        if acc:
            self.stats["spec_accepted"] += acc
            _TM_SPEC_ACCEPTED.inc(acc)

    def step(self):
        """One scheduling round: drain everything first under speculation
        (drafting reads the drained tokens and exact positions), retire
        cancelled and expired requests (the round-boundary sweep), run ONE
        piece of the oldest request still prefilled in pieces, admit
        staged requests into free slots (prefix copy + first piece), run
        one verify round — or the plain decode round when no slot drafted
        — if any slot has a sequence to decode, then drain the token
        vectors that are ``drain_depth`` rounds old (all of them once
        nothing is in flight). Returns the requests that finished since
        the last round — completions AND host retirements (check
        ``retire_reason``) — in completion order.

        Every round that did something lands a row in the round-phase
        ledger (:meth:`round_table`) and feeds the
        ``serving.round_phase_ms.*`` histograms: its wall time split into
        drain, prefix lookup, h2d staging, prefill, copy and
        decode/verify dispatch, with host scheduling as the exact
        remainder."""
        self._check_open()
        rt0 = time.perf_counter()
        self._phase = {}
        dispatched = None
        try:
            if self._spec:
                while self._drain:
                    self._drain_one()
            self._sweep()
            # chunked prefill: at most ~prefill_chunk tokens of prefill
            # work run between decode rounds — one piece of the oldest
            # parked request, then admissions' first pieces until the
            # budget is spent
            self._round_budget = self.prefill_chunk or float("inf")
            if self._chunking:
                st = self._chunking.popleft()
                try:
                    if not self._advance_chunk(st):
                        self._chunking.append(st)
                except Exception as e:   # noqa: BLE001 — poisoned
                    self._poison(st, e)
            admitted = self._admit()
            busy = self.slots - len(self._free)
            _TM_OCCUPANCY.set(busy)
            if admitted or busy:
                _TM_ADMITTED.observe(admitted)
            # slots still mid-prefill have nothing to decode, nor slots a
            # handoff pins (their requests left); a prefill-role engine
            # never runs the decode family: that is its role's contract
            if busy - len(self._chunking) - len(self._handoff_slots) > 0 \
                    and self.role != "prefill":
                if self._spec and self._spec_round(busy):
                    dispatched = "verify"
                else:
                    if self._spec:
                        _TM_SPEC_FALLBACK.inc()
                        self.stats["spec_fallback_rounds"] += 1
                    td0 = time.perf_counter()
                    with tele.span("serving.decode_round", cat="serving",
                                   slots_busy=busy):
                        block = self._decode_round()
                        ev = self._dispatched()
                    self._phase_add("dispatch", time.perf_counter() - td0)
                    dispatched = "decode"
                    self._drain.append(("step", block, ev))
                    _TM_ROUNDS.inc()
                    _TM_SLOTS_BUSY.observe(busy)
                    flt = _SERVING_FAULTS
                    if flt is not None:
                        flt.serving_crash()   # injected process death
            # a prefill-role engine drains at once: no decode round follows
            # to push a first token out of the drain window, and each one
            # is a package the router is waiting on
            while len(self._drain) > (
                    self._drain_depth
                    if self._busy() and self.role != "prefill" else 0):
                self._drain_one()
            self._last_ok_t = time.perf_counter()
            self._slo_tick(self._last_ok_t)
            self._record_round(rt0, busy, admitted, dispatched)
        finally:
            self._phase = None
        done, self._done_buf = self._done_buf, []
        return done

    # -- observability (the JAX package's l.3158-3290) ----------------------
    def _record_round(self, rt0, busy, admitted, dispatched):
        """Land the finished round in the phase ledger and histograms.
        Idle polls (nothing resident, admitted or drained) are not
        scheduling rounds; an aborted round (a watchdog trip unwinding
        step()) records nothing — its drain retries next round."""
        acc = self._phase
        wall = time.perf_counter() - rt0
        if not (admitted or busy or acc):
            return
        # host scheduling = the unattributed remainder; the attributed
        # phases are disjoint intervals inside [rt0, now], so it is >= 0
        # up to float error
        acc["sched"] = max(0.0, wall - sum(acc.values()))
        phases_ms = {k: round(v * 1e3, 4) for k, v in acc.items()}
        for k, v in phases_ms.items():
            _TM_PHASE[k].observe(v)
        _TM_ROUND_WALL.observe(wall * 1e3)
        self._round_no += 1
        self._rounds.append({
            "round": self._round_no,
            "t_s": round(rt0 - self._t0, 4),
            "wall_ms": round(wall * 1e3, 4),
            "slots_busy": busy,
            "admitted": admitted,
            "dispatched": dispatched,
            "phases_ms": phases_ms,
        })

    def round_table(self, n=None):
        """The last ``n`` (default: all retained, at most 256) rows of the
        round-phase ledger, oldest first: round number, start time (s
        since the engine was built), wall ms, occupancy, admissions, the
        program the round dispatched (``"decode"``/``"verify"``/None) and
        the per-phase ms split (summing to ``wall_ms``)."""
        rows = list(self._rounds)
        if n is not None:
            n = max(0, int(n))
            rows = rows[-n:] if n else []
        return [dict(r, phases_ms=dict(r["phases_ms"])) for r in rows]

    def _slo_tick(self, now=None):
        """Refresh the multi-window SLO burn gauges from the TTFT and
        cadence histograms (rate-limited inside ``tele.SloWindow``). The
        histograms are process-wide: with several engines in one process
        the gauges reflect the engine that ticked last."""
        for kind, thr, hist, windows in (
                ("ttft", self.slo_ttft_ms, _TM_TTFT_MS, _SLO_TTFT_WINDOWS),
                ("cadence", self.slo_cadence_ms, _TM_CADENCE_MS,
                 _SLO_CADENCE_WINDOWS)):
            if thr is None:
                continue
            w = self._slo_windows.get(kind)
            if w is None or w.threshold != float(thr):
                # (re)built on first use or a threshold change: the
                # window history restarts with the target
                w = tele.SloWindow(hist, thr, target=self.slo_target,
                                   windows=windows)
                self._slo_windows[kind] = w
            w.tick(now)

    def health(self):
        """Liveness summary (plain dict, host-side): ``stuck`` is True from
        a ``round_timeout_ms`` trip until a later drain succeeds;
        ``closed`` after :meth:`close`; ``last_round_age_s`` is how long
        since a ``step()`` completed; ``draining``, ``role`` and
        ``handoffs_waiting`` (packaged prefills not yet taken by the
        router) are the fleet's fields."""
        now = time.perf_counter()
        return {
            "closed": self._closed,
            "stuck": self._watchdog_stuck_t is not None,
            "draining": self.draining,
            "role": self.role,
            "watchdog_trips": self.stats["watchdog_trips"],
            "slots": self.slots,
            "slots_busy": self.slots - len(self._free),
            "queued": self.queued(),
            "handoffs_waiting": len(self._handoff_out),
            "last_round_age_s": round(now - self._last_ok_t, 3),
        }

    def request_table(self):
        """Live and recently retired request rows: every unfinished
        request (queued, staged, mid-prefill or decoding), then the flight
        recorder's retired ring. Plain dicts, host bookkeeping only."""
        now = time.perf_counter()
        rows = []
        for req in list(self._active.values()):
            if req.done:
                continue
            rows.append({
                "id": req.id,
                "state": "queued" if req.t_admit is None else "running",
                "prompt_len": int(len(req.prompt)),
                "tokens": len(req.tokens),
                "age_s": round(now - req.t_submit, 3),
                "deadline_ms": req.deadline_ms,
                "prefix_hit_tokens": req.prefix_hit_tokens,
            })
        rows.extend(self.flight.rows())
        # several engines in one process share one /requests endpoint:
        # each row names its engine and role
        for row in rows:
            row["engine_id"] = self.engine_id
            row["role"] = self.role
        return rows

    # -- lifecycle (the JAX package's l.3292-3410) ----------------------------
    def serve_forever(self, requests=None):
        """Drive the loop to completion: pull submissions from
        ``requests`` (optional iterable — dict kwargs for :meth:`submit`,
        a ``(prompt, kwargs)`` pair, a bare prompt array, or ``None``
        meaning "nothing has arrived yet", which lets a generator pace an
        arrival process), stepping continuously. Returns every finished
        request in completion order (host retirements included). With
        ``requests=None`` it serves what was already submitted and
        returns when idle.

        If the ``requests`` iterable (or a submit it drives) raises,
        already-admitted work FINISHES first — queued requests finish too
        under ``overload="block"``, or are shed under a shedding policy —
        and then the exception propagates. On KeyboardInterrupt the engine
        :meth:`close`\\ s before the interrupt propagates."""
        self._check_open()
        completed = []
        src = iter(requests) if requests is not None else None
        exhausted = src is None
        ingest_error = None
        try:
            while True:
                # ingest until backpressure or a pacing None
                while not exhausted and self.queued() < self.max_queue:
                    try:
                        item = next(src)
                    except StopIteration:
                        exhausted = True
                        break
                    except Exception as e:   # noqa: BLE001
                        ingest_error = e
                        break
                    try:
                        if item is None:
                            break          # nothing ready yet: decode
                        if isinstance(item, dict):
                            self.submit(**item)
                        elif isinstance(item, tuple) and len(item) == 2 \
                                and isinstance(item[1], dict):
                            self.submit(item[0], **item[1])
                        else:
                            self.submit(item, max_tokens=self.max_len)
                    except Exception as e:   # noqa: BLE001
                        ingest_error = e
                        break
                if ingest_error is not None and not exhausted:
                    # stop ingesting; shed the unadmitted backlog when the
                    # policy allows, then drain what was admitted
                    exhausted = True
                    if self.overload != "block":
                        why = ("with the unadmitted backlog after the "
                               "request stream raised (overload=%r drops "
                               "instead of draining it)" % self.overload)
                        while self._shed_oldest(why):
                            pass
                completed.extend(self.step())
                if exhausted and self.idle:
                    break
            if ingest_error is not None:
                raise ingest_error
            return completed
        except KeyboardInterrupt:
            self.close()
            raise

    def close(self):
        """Shut the engine down: every pending request — queued, staged,
        mid-prefill or decoding — fails with a typed :class:`EngineClosed`
        (``retire_reason="closed"``; drained tokens stay readable on
        ``.tokens``), every slot and prefix-cache pin is released, packages
        not yet delivered die with the engine (marked resolved: their rows
        are gone), the capture file closes, and the engine's device memory
        goes: its programs (each capture and its graph's memory pool),
        caches, prefix pool, handoff staging, state vectors and its own
        weight copy — only what it owns: a decoder's weights that other
        engines serve from stay as they are. Idempotent; ``submit``/``step``/
        ``serve_forever`` raise :class:`EngineClosed` afterwards. Also a
        context manager (``with engine: ...`` closes on exit)."""
        if self._closed:
            return
        self._closed = True
        self._watchdog_stuck_t = None
        for req in list(self._active.values()):
            self._retire_active(req, "closed", EngineClosed(
                "InferenceEngine: engine closed while request %r was "
                "pending" % (req.id,)))
        self._pending.clear()
        self._chunking.clear()
        self._held = None
        self._drain.clear()
        while self._handoff_out:
            self._handoff_out.popleft().resolved = True
        for slot in sorted(self._handoff_slots):
            self._release_slot(slot)
        self._handoff_slots.clear()
        self._stager.close()
        self.capture.close()
        # each program and this engine refer to each other: dropping the
        # engine's side frees the captures now, not at the next cycle
        # collection
        self._programs.clear()
        for name in _DEVICE_STATE:
            if hasattr(self, name):
                setattr(self, name, None)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.close()
        return False

    # -- crash-safe restart (the JAX package's l.3412-3572) -------------------
    def snapshot(self):
        """Host scheduler state as a plain JSON-serializable dict (the JAX
        package's version 1, key for key): every unfinished request
        (queued AND in flight) with its prompt, the tokens drained so far,
        its sampling identity (seed/temperature: draws are a function of
        the seed and the position, so a resumed request reproduces them)
        and its remaining deadline budget, plus the engine's geometry. NO
        device state: :meth:`restore` prefills each prompt (through the
        prefix cache where it hits) and regenerates the emitted tokens, so
        every greedy continuation equals the uninterrupted run's. Valid
        after a crashed ``step()`` or a watchdog trip — tokens dispatched
        but never drained are simply generated again."""
        now = time.perf_counter()
        reqs = []
        for req in self._active.values():
            if req.done:
                continue
            reqs.append({
                "id": req.id,
                "prompt": np.asarray(req.prompt).tolist(),
                "tokens": list(req.tokens),
                "max_tokens": int(req.max_tokens),
                "eos_id": req.eos_id,
                "temperature": float(req.temperature),
                "seed": int(req.seed),
                "deadline_ms": None if req._deadline is None
                else (req._deadline - now) * 1e3,
                "ttft_deadline_ms": None
                if req._ttft_deadline is None or req.t_first is not None
                else (req._ttft_deadline - now) * 1e3,
            })
        # packaged but undelivered handoffs: retired here, not done — a
        # restore (or the fleet's failover) serves them on
        for pkg in self._handoff_out:
            if pkg.resolved:
                continue
            reqs.append({
                "id": pkg.id,
                "prompt": pkg.prompt.tolist(),
                "tokens": list(pkg.tokens),
                "max_tokens": int(pkg.max_tokens),
                "eos_id": pkg.eos_id,
                "temperature": float(pkg.temperature),
                "seed": int(pkg.seed),
                "deadline_ms": None,
                "ttft_deadline_ms": None,
            })
        return {
            "version": 1,
            "auto_seed": self._auto_seed,
            "engine_id": self.engine_id,
            "engine": self._geometry(),
            "requests": reqs,
        }

    def _geometry(self):
        """The engine's geometry as plain JSON: every constructor knob a
        fresh engine needs to serve the same way, the JAX package's keys.
        Shared by
        :meth:`snapshot` and the capture header; ``capture_dir`` is None
        in the header (written before the knob resolves: a replay must
        not capture again by default)."""
        return {
            "slots": self.slots,
            "prefill_buckets": list(self.prefill_buckets),
            "max_queue": self.max_queue,
            "stage_depth": self.stage_depth,
            "drain_depth": self._drain_depth,
            "steps_per_round": self.steps_per_round,
            "prefix_cache_mb": self.prefix_cache_mb,
            "prefill_chunk": self.prefill_chunk,
            "overload": self.overload,
            "round_timeout_ms": self.round_timeout_ms,
            "slo_ttft_ms": self.slo_ttft_ms,
            "slo_cadence_ms": self.slo_cadence_ms,
            "slo_target": self.slo_target,
            "flight_recorder": self.flight.retain,
            "spec_k": self.spec_k,
            "draft": self.spec_draft,
            "attn_impl": self.attn_impl,
            "tp": self.tp,
            "ep": self.ep,
            "weight_dtype": self.weight_dtype,
            "weight_group": self.weight_group,
            "matmul_impl": self.matmul_impl,
            "role": self.role,
            "handoff_dtype": self.handoff_dtype,
            "capture_dir": getattr(self, "capture_dir", None),
        }

    @classmethod
    def restore(cls, snap, decoder, **overrides):
        """Warm restart from :meth:`snapshot` (this package's or the JAX
        package's): builds a fresh engine (the same geometry unless
        ``overrides`` change it) on ``decoder`` (the same weights) and
        resubmits every unfinished request. Each prefills its prompt and
        regenerates its emitted tokens through the engine's rounds, checked
        against the snapshot and not emitted again (:class:`Request`:
        a prefill of them would round their K/V rows differently), so that
        a greedy continuation equals an uninterrupted run's bit for bit on
        the card too, and sampled draws stay position-keyed (within one
        package: the two draw differently). Emitted tokens are on the
        handles' ``.tokens`` from the start. Remaining deadline budgets
        carry over. Returns ``(engine,
        {request_id: Request})``. A ``draft="model"`` snapshot needs the
        draft model back: pass ``draft_decoder=...`` in ``overrides``. The
        snapshot's ``tp`` and ``ep`` are rebuilt as the constructor
        resolves degrees without a mesh; ``tp``/``ep`` in ``overrides``
        replace them, and a ``mesh`` replaces both (its ``expert`` axis
        gives ep, 1 without one), so a tp=2 or ep=2 snapshot restores at
        1, or on ranks of one card. The JAX engine's default
        ``attn_impl="dense"`` is honoured over a dense ``decoder`` and gives
        way to ``"paged"`` over a paged one (the port's default), as in
        :func:`~.replay.build_engine`: the read is not request content. A
        snapshot's ``capture_dir`` makes the restored engine capture into
        a fresh file in that directory, its header naming the donor
        (``migrated_from``)."""
        if not isinstance(snap, dict) or snap.get("version") != 1:
            raise MXNetError(
                "InferenceEngine.restore: not an engine snapshot "
                "(want the dict snapshot() returned)")
        cfg = dict(snap["engine"])
        cfg["prefill_buckets"] = tuple(cfg["prefill_buckets"])
        if cfg.get("attn_impl") == "dense" and decoder._attn_impl == "paged":
            cfg["attn_impl"] = "paged"
        if "mesh" in overrides:
            cfg.pop("tp", None)
            if "ep" not in overrides \
                    and isinstance(overrides["mesh"], Mesh):
                cfg["ep"] = int(overrides["mesh"].shape.get("expert", 1))
        cfg.update(overrides)
        cfg.setdefault("migrated_from", snap.get("engine_id"))
        eng = cls(decoder, **cfg)
        handles = {}
        real_max_queue = eng.max_queue
        # resubmission must never shed: the crashed engine had already
        # accepted this work
        eng.max_queue = max(real_max_queue, len(snap["requests"]))
        try:
            next_id = eng._next_id
            for r in snap["requests"]:
                req = eng.submit(
                    np.asarray(r["prompt"], np.int64),
                    max_tokens=r["max_tokens"], eos_id=r["eos_id"],
                    temperature=r["temperature"], seed=r["seed"],
                    request_id=r["id"],
                    deadline_ms=r.get("deadline_ms"),
                    ttft_deadline_ms=r.get("ttft_deadline_ms"),
                    _resume_tokens=r["tokens"])
                handles[req.id] = req
                if isinstance(req.id, int):
                    next_id = max(next_id, req.id + 1)
            eng._next_id = next_id   # fresh auto-ids never collide
            # likewise fresh auto-drawn seeds
            eng._auto_seed = max(int(snap.get("auto_seed", 0)),
                                 *(int(r["seed"]) + 1
                                   for r in snap["requests"]), 0)
        finally:
            eng.max_queue = real_max_queue
        eng.stats["restores"] = 1
        _TM_RESTORES.inc()
        return eng, handles
