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

Tensor/expert parallelism, prompt staging (``stage_depth``), overload
policies, deadlines, the watchdog, SLO accounting, the flight recorder,
trace capture (``capture_dir``), snapshot/restore and fleet roles belong
to later slices of the port.
"""
from __future__ import annotations

import collections
import functools
import math
import os
import time

import numpy as np
import torch

from ..base import MXNetError, refuse_unported
from ..parallel.decode import Decoder, sample_tokens, uniform_draw
from ..parallel.program import Program
from .prefix import PrefixCache
from .quant import QuantizedTensor, quantize_params, quantized_weight_names
from .spec import NgramDrafter

__all__ = ["InferenceEngine", "Request"]

# hard bound on reserved prefix-pool slots (the JAX package's): the byte
# budget is the real knob; this only stops a tiny model and a big budget
# from minting a silly slot axis
_MAX_POOL_SLOTS = 256


class Request:
    """One submitted generation request (the handle ``submit`` returns).

    ``tokens`` fills in as output drains (generated ids only, including
    ``eos_id`` when hit); ``done`` flips when the sequence retires with
    ``retire_reason`` ``"eos"`` or ``"length"``; ``result()`` returns the
    tokens as int32 numpy. ``t_submit``/``t_admit``/``t_first``/
    ``t_done`` are ``time.perf_counter`` seconds (first = first token
    drained, i.e. visible to the caller). ``prefix_hit_tokens`` counts
    the prompt positions whose K/V came from the prefix cache instead of
    a prefill; ``prefill_chunks`` the prefill pieces that admitted the
    prompt (1 unless ``prefill_chunk`` split it)."""

    def __init__(self, rid, prompt, max_tokens, eos_id, temperature, seed,
                 limit):
        self.id = rid
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.eos_id = eos_id
        self.temperature = temperature
        self.seed = seed
        self.limit = limit          # min(max_tokens, max_len - P)
        self.tokens = []
        self.done = False
        self.retire_reason = None
        self.t_submit = time.perf_counter()
        self.t_admit = None
        self.t_first = None
        self.t_done = None
        self.prefix_hit_tokens = 0
        self.prefill_chunks = 0

    def result(self):
        if not self.done:
            raise MXNetError("request %s is not finished" % self.id)
        return np.asarray(self.tokens, np.int32)

    def __repr__(self):
        return ("Request(id=%r, prompt_len=%d, max_tokens=%d, done=%s, "
                "generated=%d)" % (self.id, len(self.prompt),
                                   self.max_tokens, self.done,
                                   len(self.tokens)))


# the prefill operands after the padded piece: slot, chunk start, the
# piece's true length, final (0/1), the temperature's float32 bits, seed,
# EOS id (-1: none), the request's token budget (the JAX ``_prefill_fn``'s
# traced operands, in its order, the PRNG key as the seed)
_N_SCALARS = 8
# the draft prefill's: slot, chunk start
_N_DRAFT_SCALARS = 2


def _default_buckets(max_len):
    out, b = [], 16
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


def _grouped_cache(one, slots, rows):
    """Cache buffers laid out like ``one`` (``Decoder.init_cache(1)``) for
    ``slots`` slots of ``rows`` rows, every buffer of one dtype and row
    shape in ONE allocation ``[count, slots, rows, ...]`` (K/V zeroed,
    int8 row scales one, as ``init_cache`` has them). Returns ``(groups,
    caches)``: the allocations, and the per-node tuples of ``[slots, rows,
    ...]`` views (each contiguous, as the kernels take them), so that a
    copy between slots runs one kernel a group instead of one a buffer."""
    keys, counts, where = [], [], []
    for entry in one:
        for b in entry:
            key = (b.dtype, tuple(b.shape[2:]))
            if key not in keys:
                keys.append(key)
                counts.append(0)
            g = keys.index(key)
            where.append((g, counts[g]))
            counts[g] += 1
    dev = one[0][0].device
    # row scales ([B, L, H]: one value a row) start at one
    groups = [(torch.ones if len(tail) == 1 else torch.zeros)(
        (n, slots, rows) + tail, dtype=dt, device=dev)
        for n, (dt, tail) in zip(counts, keys)]
    it = iter(where)
    caches = [tuple(groups[g][i] for g, i in (next(it) for _ in entry))
              for entry in one]
    return groups, caches


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
    return sum(b.numel() * b.element_size() for e in caches for b in e)


class InferenceEngine:
    """Continuous-batching serving loop over a :class:`Decoder`.

    Parameters
    ----------
    decoder : Decoder
        The derived incremental program (paged; int8 or float KV; GQA,
        rope).
    slots : int
        ``S``, the resident-sequence capacity (the decode batch).
    prefill_buckets : tuple of int, optional
        Ascending prompt-padding lengths (default: powers of two from 16,
        capped at ``max_len``); a prompt (or a chunk piece) takes the
        smallest bucket that holds it.
    max_queue : int
        Submitted-but-not-admitted requests beyond which ``submit``
        raises ``MXNetError``.
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
        Default to the decoder's; ``attn_impl`` must be ``"paged"``.
    stage_depth, overload, round_timeout_ms, slo_ttft_ms, slo_cadence_ms,
    slo_target, flight_recorder, capture_dir, capture_mb, tp, mesh, ep,
    engine_id, migrated_from, role, handoff_dtype :
        The JAX package's parameters, in its order. Any value but the
        default raises: prompt staging, overload policies, the watchdog,
        SLO accounting, the flight recorder, capture, tensor/expert
        parallelism and fleet roles belong to later slices.
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
        refuse_unported(
            "InferenceEngine", stage_depth=(stage_depth, 2),
            overload=(overload, None),
            round_timeout_ms=(round_timeout_ms, None),
            slo_ttft_ms=(slo_ttft_ms, None),
            slo_cadence_ms=(slo_cadence_ms, None),
            slo_target=(slo_target, 0.99),
            flight_recorder=(flight_recorder, None),
            capture_dir=(capture_dir, None), capture_mb=(capture_mb, None),
            tp=(tp, None), mesh=(mesh, None), ep=(ep, None),
            engine_id=(engine_id, None),
            migrated_from=(migrated_from, None), role=(role, None),
            handoff_dtype=(handoff_dtype, None))
        self._dec = decoder
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
        if prefix_cache_mb is None:
            prefix_cache_mb = float(os.environ.get(
                "MXNET_SERVING_PREFIX_CACHE_MB") or "64")
        self.prefix_cache_mb = float(prefix_cache_mb)
        if self.prefix_cache_mb < 0:
            raise MXNetError("InferenceEngine: prefix_cache_mb must "
                             "be >= 0 (0 disables the prefix cache)")
        if attn_impl is None:
            attn_impl = decoder._attn_impl
        if attn_impl != "paged":
            raise MXNetError("InferenceEngine: the PyTorch port serves "
                             "attn_impl='paged', got %r" % (attn_impl,))
        self.attn_impl = attn_impl
        if matmul_impl is None:
            matmul_impl = decoder._matmul_impl
        if matmul_impl not in ("dense", "pallas", "fused"):
            raise MXNetError(
                "InferenceEngine: matmul_impl must be 'dense', 'pallas' "
                "or 'fused', got %r" % (matmul_impl,))
        self.matmul_impl = matmul_impl

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
        self.spec_draft = draft
        self._spec = draft != "off"
        self._drafters = {}           # request id -> NgramDrafter
        self._draft_dec = None
        wbytes = self._weight_nbytes(params)
        if draft == "model":
            self._draft_dec = self._check_draft(draft_decoder)
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
        one = decoder.init_cache(1)
        slot_bytes = _nbytes(one)
        pool = 0
        if self.prefix_cache_mb > 0:
            pool = min(int(self.prefix_cache_mb * 2 ** 20)
                       // max(1, slot_bytes), _MAX_POOL_SLOTS)
        self._groups, self._cache_bufs = _grouped_cache(
            one, S + pool, self.max_len)
        self._caches = [tuple(b[:S] for b in e) for e in self._cache_bufs]
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
            one = self._draft_dec.init_cache(1)
            self._draft_groups, self._draft_caches = _grouped_cache(
                one, S, self.max_len)
            self._draft_stage_groups, self._draft_stage = _grouped_cache(
                one, 1, self.max_len + buckets[-1])
            del one
            self._draft_pos = [0] * S     # next draft-cache position
            self._draft_pending = [[] for _ in range(S)]
        self._programs = {}
        self._compile_log = []

        # host-side scheduler state
        self._pending = collections.deque()
        self._free = collections.deque(range(S))   # FIFO slot recycling
        self._mirror = [None] * S    # drain-side view: slot -> Request
        self._drain = collections.deque()
        # requests admitted to a slot whose prompt is still prefilled in
        # pieces, oldest first; plus one admission candidate held over
        # when a round's prefill budget ran out
        self._chunking = collections.deque()
        self._held = None
        self._round_budget = float("inf")
        self._done_buf = []
        self._next_id = 0
        self._auto_seed = 0
        self.stats = {"submitted": 0, "completed": 0, "prefills": 0,
                      "steps": 0, "tokens": 0, "prefix_hits": 0,
                      "prefix_hit_tokens": 0, "prefill_chunks": 0,
                      "prefix_copies": 0, "spec_rounds": 0,
                      "spec_fallback_rounds": 0, "spec_drafted": 0,
                      "spec_accepted": 0}

    @staticmethod
    def _weight_nbytes(params):
        return sum(v.nbytes if isinstance(v, QuantizedTensor)
                   else v.numel() * v.element_size()
                   for v in params.values())

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
        later = dict(
            stage_depth=stage_depth, overload=overload,
            round_timeout_ms=round_timeout_ms, slo_ttft_ms=slo_ttft_ms,
            slo_cadence_ms=slo_cadence_ms, slo_target=slo_target,
            flight_recorder=flight_recorder, capture_dir=capture_dir,
            tp=tp, mesh=mesh)
        decoder_kwargs.setdefault("weight_dtype", weight_dtype)
        if attn_impl is not None:
            decoder_kwargs.setdefault("attn_impl", attn_impl)
        dec = Decoder.from_checkpoint(prefix, epoch, max_len,
                                      **decoder_kwargs)
        if draft_prefix is not None and draft_decoder is None:
            draft_decoder = Decoder.from_checkpoint(
                draft_prefix, 0 if draft_epoch is None else draft_epoch,
                max_len, cache_block=None,
                compute_dtype=decoder_kwargs.get("compute_dtype"),
                weight_dtype=decoder_kwargs["weight_dtype"],
                device=decoder_kwargs.get("device"))
            if draft is None:
                draft = "model"
        return cls(dec, slots=slots, prefill_buckets=prefill_buckets,
                   max_queue=max_queue, drain_depth=drain_depth,
                   steps_per_round=steps_per_round,
                   prefix_cache_mb=prefix_cache_mb,
                   prefill_chunk=prefill_chunk, spec_k=spec_k, draft=draft,
                   draft_decoder=draft_decoder, **later)

    # -- scheduling -----------------------------------------------------
    def _bucket_for(self, n):
        for b in self.prefill_buckets:
            if b >= n:
                return b
        raise MXNetError(
            "InferenceEngine: prompt length %d exceeds the largest "
            "prefill bucket %d" % (n, self.prefill_buckets[-1]))

    def queued(self):
        """Requests submitted but not yet admitted to a slot."""
        return len(self._pending) + (self._held is not None)

    @property
    def idle(self):
        return not self._pending and self._held is None \
            and len(self._free) == self.slots and not self._drain

    def _busy(self):
        return self.slots - len(self._free) > 0 or bool(self._pending) \
            or self._held is not None

    def submit(self, prompt, max_tokens, eos_id=None, temperature=0.0,
               seed=None, request_id=None, deadline_ms=None,
               ttft_deadline_ms=None, _resume_tokens=(), _trace=None):
        """Queue one generation request; returns its :class:`Request`.

        prompt: 1-D integer sequence, ``1 <= len <= max_len - 1``, and
        within the largest bucket unless ``prefill_chunk`` is on; at most
        ``max_len - len(prompt)`` tokens come back. ``eos_id`` stops
        generation after it is emitted. ``temperature=0`` is greedy; > 0
        samples with ``seed`` (drawn from a counter when omitted). A full
        queue raises. ``deadline_ms``, ``ttft_deadline_ms`` (request
        deadlines), ``_resume_tokens`` (a migrated request's tokens) and
        ``_trace`` (fleet trace context) raise unless at their defaults:
        they belong to a later slice."""
        refuse_unported("InferenceEngine.submit",
                        deadline_ms=(deadline_ms, None),
                        ttft_deadline_ms=(ttft_deadline_ms, None),
                        _resume_tokens=(tuple(_resume_tokens), ()),
                        _trace=(_trace, None))
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
        if prompt.size > self.max_len - 1:
            raise MXNetError(
                "InferenceEngine: prompt length %d leaves no room to "
                "generate (max_len=%d)" % (prompt.size, self.max_len))
        if not self.prefill_chunk:
            # whole-prompt prefill must fit one bucket program; chunked
            # engines serve any prompt <= max_len - 1 in pieces
            self._bucket_for(prompt.size)
        max_tokens = int(max_tokens)
        if max_tokens < 1:
            raise MXNetError("InferenceEngine: max_tokens must be >= 1")
        if eos_id is not None:
            e = np.asarray(eos_id)
            if e.ndim != 0 or not np.issubdtype(e.dtype, np.integer) \
                    or int(e) < 0:
                raise MXNetError(
                    "InferenceEngine: eos_id must be a scalar integer "
                    "token id >= 0, got %r" % (eos_id,))
            eos_id = int(e)
        try:
            temp = float(temperature)
        except (TypeError, ValueError):
            temp = float("nan")
        if math.isnan(temp) or math.isinf(temp) or temp < 0:
            raise MXNetError(
                "InferenceEngine: temperature must be a finite float >= 0, "
                "got %r (0 = greedy)" % (temperature,))
        if self.queued() >= self.max_queue:
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
                      min(max_tokens, self.max_len - prompt.size))
        self._pending.append(req)
        self.stats["submitted"] += 1
        return req

    def _release_slot(self, slot):
        self._mirror[slot] = None
        self._free.append(slot)

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
        ``'draft_prefill'`` ({bucket: 1}). On the card a count is a
        capture; on the CPU, a program's first run."""
        out = {"decode": 0, "verify": 0, "prefill": {}, "copy": {}}
        if self.spec_draft == "model":
            out["draft"] = 0
            out["draft_prefill"] = {}
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
        prog = self._programs[tag] = Program(
            fn, operands, mutable=self._state(),
            name="InferenceEngine %s program" % (tag,), tag=tag,
            log=self._compile_log, device=self.device)
        return prog

    def _staged_run(self, dec, params, aux, groups, stage_groups, stage,
                    slot, start, tokens):
        """One prefill piece of ``tokens`` [1, bucket] at ``start`` into
        ``slot`` of the cache allocations ``groups``, run over the staging
        cache ``stage`` (allocations ``stage_groups``): the gather-in (the
        slot's rows ``[0, max_len)`` copied into the staging rows, so that
        a piece at ``start > 0`` sees the rows earlier pieces or a prefix
        copy left there; in a graph the copy has a fixed shape, all
        ``max_len`` rows, one kernel an allocation), the walk, then the
        piece's rows ``[start, start + bucket)`` written back to the slot
        (those past ``max_len`` are pad rows and are not). Returns the
        logits [1, bucket, V]."""
        n = self.max_len
        for g, sg in zip(groups, stage_groups):
            torch.index_select(_wide(g), 1, slot, out=_wide(sg)[:, :, :n])
        logits, _ = dec._run(params, aux, stage, start.to(torch.int32),
                             tokens, mm_impl=self.matmul_impl)
        rows = (start + torch.arange(tokens.shape[1], device=start.device)
                ).clamp_max(n - 1)
        for g, sg in zip(groups, stage_groups):
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
                                  ops[None, :bucket])
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
                self._tok[:, None], mm_impl=self.matmul_impl)
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
             self._eos, self._last), drafts, dlen,
            mm_impl=self.matmul_impl)
        for buf, val in zip((self._pos, self._tok, self._live), st):
            buf.copy_(val)
        return out

    def _draft_fn(self, pos, catchup, clen):
        """The draft program (``Decoder.draft_propose_slots``): the draft
        cache catches up on what the target emitted, then proposes
        ``spec_k`` greedy tokens a slot. Returns the [S, K] drafts."""
        _, props = self._draft_dec.draft_propose_slots(
            self._draft_params, self._draft_aux, self._draft_caches, pos,
            catchup, clen, self.spec_k, mm_impl=self.matmul_impl)
        return props

    def _draft_prefill_fn(self, bucket, ops):
        """The draft model's prefill program of ``bucket``: the padded
        piece's K/V into the slot (``ops``: the piece, then the slot and
        the start) of the draft cache, through its own
        staging cache. No sampling and no state: the draft program decodes
        from this cache."""
        slot, start = ops[bucket:bucket + 1], ops[bucket + 1:bucket + 2]
        self._staged_run(self._draft_dec, self._draft_params,
                         self._draft_aux, self._draft_groups,
                         self._draft_stage_groups, self._draft_stage, slot,
                         start, ops[None, :bucket])

    # -- admission --------------------------------------------------------
    def _suffix_cost(self, n):
        """Prefill work of an ``n``-token suffix: the padded tokens of its
        pieces (what bucket quantization charges for), split as
        :meth:`_advance_chunk` splits it."""
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
        self._program(("copy", bucket))(ops=np.array(
            [src + S * bool(src_pool), dst + S * bool(dst_pool)], np.int64))
        self.stats["prefix_copies"] += 1

    def _advance_chunk(self, st):
        """Run the next prefill piece of an admitted request: the whole
        remaining suffix when chunking is off (or it fits), else one
        ``prefill_chunk`` piece. The final piece picks the first token and
        (prefix cache on) retains the prompt's K/V in the pool. Returns
        True once the final piece ran."""
        req, slot = st["req"], st["slot"]
        start = st["next"]
        p = len(req.prompt)
        piece = min(p - start,
                    self.prefill_chunk or self.prefill_buckets[-1])
        final = start + piece == p
        bucket = self._bucket_for(piece)
        ops = np.zeros(bucket + _N_SCALARS, np.int64)
        ops[:piece] = req.prompt[start:start + piece]
        tbits = int(np.float32(req.temperature).view(np.int32))
        seed = (req.seed + 2 ** 63) % 2 ** 64 - 2 ** 63   # as int64
        ops[bucket:] = (slot, start, piece, final, tbits, seed,
                        -1 if req.eos_id is None else req.eos_id,
                        req.limit)
        t0 = self._program(("prefill", bucket))(ops=ops)
        req.prefill_chunks += 1
        st["next"] = start + piece
        self.stats["prefill_chunks"] += 1
        self._round_budget -= piece
        if not final:
            return False
        # the first token stays on the card until drained (a copy: the
        # next run of the program overwrites its output)
        self._drain.append(("prefill", req, slot, t0.clone()))
        self.stats["prefills"] += 1
        if st["entry"] is not None:
            self._prefix.release(st["entry"])
            st["entry"] = None
        # a duplicate prompt admitted while this one was mid-chunk may
        # have retained the same tokens first: its rows are the same
        if st["insert"] and self._prefix.get(req.prompt) is None:
            new = self._prefix.insert(req.prompt)
            if new is not None:
                try:
                    # the slot's rows [0, P) are the prompt's K/V now;
                    # the copy runs before any later program on the stream
                    self._dispatch_copy(p, src=slot, dst=new.slot,
                                        src_pool=False, dst_pool=True)
                except Exception:
                    self._prefix.discard(new)
                    raise
        return True

    def _draft_prefill_all(self, req, slot):
        """Build the draft model's cache for a freshly admitted slot: the
        whole prompt in pieces of the largest bucket at most, at
        admission (the draft model is small, so its prefill is not
        budgeted, and it ignores prefix hits: the pool holds target K/V
        only). Resets the slot's draft clock and pending tokens."""
        p = len(req.prompt)
        start = 0
        top = self.prefill_buckets[-1]
        while start < p:
            piece = min(p - start, top)
            bucket = self._bucket_for(piece)
            ops = np.zeros(bucket + _N_DRAFT_SCALARS, np.int64)
            ops[:piece] = req.prompt[start:start + piece]
            ops[bucket:] = (slot, start)
            self._program(("draft_prefill", bucket))(ops=ops)
            start += piece
        self._draft_pos[slot] = p
        self._draft_pending[slot] = []

    def _admit(self):
        """Fill free slots from the queue, between decode rounds: a
        prefix-cache lookup (the longest retained prefix, copied into the
        slot), then the first prefill piece of the uncovered suffix;
        further pieces run one a round (:meth:`step`). Under chunking each
        first piece draws from the round's prefill budget; a request whose
        piece does not fit is held and admitted first next round."""
        admitted = 0
        while self._free:
            if self._held is not None:
                req, self._held = self._held, None
            elif self._pending:
                req = self._pending.popleft()
            else:
                break
            p = len(req.prompt)
            hit, entry, depth = 0, None, 0
            if self._prefix is not None:
                depth, entry = self._prefix.lookup(req.prompt)
                # a full hit still prefills the last prompt token: the
                # pool holds K/V only, and the first token needs logits
                hit = min(depth, p - 1)
                # a hit must lower the prefill work, else the copy is
                # pure overhead on the same bucketed prefill: a miss
                if hit > 0 and self._suffix_cost(p - hit) \
                        >= self._suffix_cost(p):
                    hit, entry = 0, None
            first_piece = min(p - hit, self.prefill_chunk or p - hit)
            if first_piece > self._round_budget:
                self._held = req
                break
            slot = self._free.popleft()
            req.t_admit = time.perf_counter()
            # retain only prompts no entry covers whole that fit the copy
            # buckets
            st = {"req": req, "slot": slot, "next": hit, "entry": None,
                  "insert": self._prefix is not None and depth < p
                  and p <= self.prefill_buckets[-1]}
            if self.spec_draft == "ngram":
                self._drafters[req.id] = NgramDrafter(req.prompt)
            elif self.spec_draft == "model":
                self._draft_prefill_all(req, slot)
            if hit > 0:
                self._prefix.acquire(entry)
                st["entry"] = entry
                req.prefix_hit_tokens = hit
                self.stats["prefix_hits"] += 1
                self.stats["prefix_hit_tokens"] += hit
                self._dispatch_copy(hit, src=entry.slot, dst=slot,
                                    src_pool=True, dst_pool=False)
            if not self._advance_chunk(st):
                self._chunking.append(st)
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

    def _spec_round(self):
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
            # eagerly)
            pos = len(req.prompt) + len(req.tokens) - 1
            if pos + K + 2 > self.max_len:
                return False
            k_s = min(K, req.limit - len(req.tokens) - 1)
            if k_s > 0:
                parts.append((s, req, k_s))
        for st in self._chunking:
            # slots parked mid-prefill ride the chunk write too
            if st["next"] + K + 2 > self.max_len:
                return False
        for entry in self._drain:
            # a slot admitted this round (not in the mirror yet) is live
            # at pos = len(prompt) and rides the chunk write
            if entry[0] == "prefill" \
                    and len(entry[1].prompt) + K + 2 > self.max_len:
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
        else:
            self._model_drafts(parts, drafts, dlen)
        if not dlen.any():
            return False
        self.stats["spec_drafted"] += int(dlen.sum())
        out = self._program("verify")(drafts=drafts, dlen=dlen).clone()
        self._drain.append(("verify", out, dlen))
        self.stats["steps"] += 1
        self.stats["spec_rounds"] += 1
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
            props = self._program("draft")(pos=pos, catchup=catchup,
                                           clen=clen)
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
        req.tokens.append(int(t))
        if self._spec:
            dr = self._drafters.get(req.id)
            if dr is not None:
                dr.append(t)          # the n-gram context stays current
            if self._draft_dec is not None:
                # the draft cache catches up on it before the next
                # proposal
                self._draft_pending[slot].append(int(t))
        if req.t_first is None:
            req.t_first = now
        self.stats["tokens"] += 1
        hit_eos = req.eos_id is not None and t == req.eos_id
        if hit_eos or len(req.tokens) >= req.limit:
            req.done = True
            req.t_done = now
            req.retire_reason = "eos" if hit_eos else "length"
            self._drafters.pop(req.id, None)
            self._release_slot(slot)
            self.stats["completed"] += 1
            self._done_buf.append(req)

    def _drain_one(self):
        entry = self._drain.popleft()
        now = time.perf_counter()
        if entry[0] == "prefill":
            _, req, slot, t0 = entry
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
        self.stats["spec_accepted"] += int(
            (emitted - 1)[(dlen > 0) & (emitted > 0)].sum())

    def step(self):
        """One scheduling round: drain everything first under speculation
        (drafting reads the drained tokens and exact positions), run ONE
        piece of the oldest request still prefilled in pieces, admit
        queued requests into free slots (prefix copy + first piece), run
        one verify round — or the plain decode round when no slot drafted
        — if any slot has a sequence to decode, then drain the token
        vectors that are ``drain_depth`` rounds old (all of them once
        nothing is in flight). Returns the requests that finished since
        the last round, in completion order."""
        if self._spec:
            while self._drain:
                self._drain_one()
        # chunked prefill: at most ~prefill_chunk tokens of prefill work
        # run between decode rounds — one piece of the oldest parked
        # request, then admissions' first pieces until the budget is spent
        self._round_budget = self.prefill_chunk or float("inf")
        if self._chunking:
            st = self._chunking.popleft()
            if not self._advance_chunk(st):
                self._chunking.append(st)
        self._admit()
        # slots still mid-prefill have nothing to decode
        if self.slots - len(self._free) - len(self._chunking) > 0:
            if not (self._spec and self._spec_round()):
                if self._spec:
                    self.stats["spec_fallback_rounds"] += 1
                self._drain.append(("step", self._decode_round()))
        busy = self._busy()
        while len(self._drain) > (self._drain_depth if busy else 0):
            self._drain_one()
        done, self._done_buf = self._done_buf, []
        return done
