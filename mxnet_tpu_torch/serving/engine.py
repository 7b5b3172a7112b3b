"""Continuous-batching serving engine over a slot-paged KV cache.

Counterpart of the core of ``mxnet_tpu/serving/engine.py``
``InferenceEngine`` (l.434): ``S`` cache slots, each holding one sequence
at its own position. A round admits queued requests into free slots —
each prompt right-padded to the smallest prefill bucket that holds it
and prefilled into its slot, its first token picked at the last real
position (l.1576-1630) — then runs ``steps_per_round`` decode steps over
all slots at once (l.1427-1491) and drains token vectors ``drain_depth``
rounds behind, so the host schedules the next round while the card works.
Requests retire on EOS or their length budget; a full queue refuses
``submit`` (``max_queue`` backpressure).

As in the JAX package, every request mix runs through a fixed set of
compiled programs (``parallel.program.Program``: CUDA graphs on the card,
the same functions over the same buffers on the CPU): ONE decode program
for a whole round of ``steps_per_round`` steps, tagged ``"decode"``, and
one prefill program per used bucket, tagged ``("prefill", bucket)``.
The slot cache, the per-slot state vectors and the programs' operand
buffers keep their addresses for the life of the engine: the programs
update them in place. A prefill's slot, length, EOS id, last position,
seed, temperature and chunk start are device operands (the JAX
``_prefill_fn``'s traced operands), so no admission adds a program;
``compile_counts`` reports them in the JAX shape, and no switch turns
capture off.

Greedy decoding is deterministic. Sampled decoding draws on the device
with ``parallel.decode.sample_tokens``, a pure function of the request's
``seed`` and the token's position (the counterpart of the JAX package's
``fold_in(seed, position)``), so a request's stream does not depend on
what else is scheduled (it cannot equal the JAX package's draws).

The prefix cache, chunked prefill, speculation, tensor/expert
parallelism, trace capture (``capture_dir``), SLO accounting, the
watchdog, the flight recorder, snapshot/restore and fleet roles belong to
later slices of the port.
"""
from __future__ import annotations

import collections
import functools
import math
import time

import numpy as np
import torch

from ..base import MXNetError, refuse_unported
from ..parallel.decode import Decoder, sample_tokens, uniform_draw
from ..parallel.program import Program
from .quant import QuantizedTensor, quantize_params, quantized_weight_names

__all__ = ["InferenceEngine", "Request"]


class Request:
    """One submitted generation request (the handle ``submit`` returns).

    ``tokens`` fills in as output drains (generated ids only, including
    ``eos_id`` when hit); ``done`` flips when the sequence retires with
    ``retire_reason`` ``"eos"`` or ``"length"``; ``result()`` returns the
    tokens as int32 numpy. ``t_submit``/``t_admit``/``t_first``/
    ``t_done`` are ``time.perf_counter`` seconds (first = first token
    drained, i.e. visible to the caller)."""

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

    def result(self):
        if not self.done:
            raise MXNetError("request %s is not finished" % self.id)
        return np.asarray(self.tokens, np.int32)

    def __repr__(self):
        return ("Request(id=%r, prompt_len=%d, max_tokens=%d, done=%s, "
                "generated=%d)" % (self.id, len(self.prompt),
                                   self.max_tokens, self.done,
                                   len(self.tokens)))


# the prefill operands after the padded prompt: slot, true length, EOS id,
# last position, seed, the temperature's float32 bits, chunk start
_N_SCALARS = 7


def _default_buckets(max_len):
    out, b = [], 16
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return tuple(out)


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
        capped at ``max_len``); a prompt takes the smallest bucket that
        holds it.
    max_queue : int
        Submitted-but-not-admitted requests beyond which ``submit``
        raises ``MXNetError``.
    drain_depth : int
        Decode rounds whose tokens may stay on the card while work is in
        flight; a slot frees at most this many rounds after its sequence
        finished (the card freezes finished slots meanwhile).
    steps_per_round : int
        Decode steps per round (one [steps, S] token drain per round).
    weight_dtype : {"float", "int8", "int4"}, optional
        Weight storage for the engine (default: the decoder's). Over a
        float decoder the engine quantizes its OWN copy, so one decoder
        can serve a quantized engine beside its float oracle.
    weight_group : int, optional
        int4 group width.
    attn_impl, matmul_impl : optional
        Default to the decoder's; ``attn_impl`` must be ``"paged"``.
    stage_depth, prefix_cache_mb, prefill_chunk, overload,
    round_timeout_ms, slo_ttft_ms, slo_cadence_ms, slo_target,
    flight_recorder, spec_k, draft, draft_decoder, capture_dir,
    capture_mb, tp, mesh, ep, engine_id, migrated_from, role,
    handoff_dtype :
        The JAX package's parameters, in its order. Any value but the
        default raises: prompt staging, the prefix cache, chunked
        prefill, overload policies, the watchdog, SLO accounting, the
        flight recorder, speculation, capture, tensor/expert parallelism
        and fleet roles belong to later slices. (``prefix_cache_mb=None``
        turns the JAX package's prefix cache on at its environment
        default; here it means none.)
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
            prefix_cache_mb=(prefix_cache_mb, None),
            prefill_chunk=(prefill_chunk, None), overload=(overload, None),
            round_timeout_ms=(round_timeout_ms, None),
            slo_ttft_ms=(slo_ttft_ms, None),
            slo_cadence_ms=(slo_cadence_ms, None),
            slo_target=(slo_target, 0.99),
            flight_recorder=(flight_recorder, None), spec_k=(spec_k, None),
            draft=(draft, None), draft_decoder=(draft_decoder, None),
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
        self.weight_bytes = sum(
            v.nbytes if isinstance(v, QuantizedTensor)
            else v.numel() * v.element_size() for v in params.values())

        # device-resident, at fixed addresses for the engine's life (the
        # programs update them in place): the slot cache, the one-slot
        # staging cache a prefill runs over, and the per-slot state
        S, dev = self.slots, self.device
        self._caches = decoder.init_cache(S)
        self._stage = decoder.init_cache(1)
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
        self._programs = {}
        self._compile_log = []

        # host-side scheduler state
        self._pending = collections.deque()
        self._free = collections.deque(range(S))   # FIFO slot recycling
        self._mirror = [None] * S    # drain-side view: slot -> Request
        self._drain = collections.deque()
        self._done_buf = []
        self._next_id = 0
        self._auto_seed = 0
        self.stats = {"submitted": 0, "completed": 0, "prefills": 0,
                      "steps": 0, "tokens": 0}

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
        ``cache_dtype``, ``device`` ...). The unported parameters raise
        as in :class:`InferenceEngine` (``draft_prefix``/``draft_epoch``,
        the draft model's checkpoint, with speculation)."""
        refuse_unported("InferenceEngine.from_checkpoint",
                        draft_prefix=(draft_prefix, None),
                        draft_epoch=(draft_epoch, None))
        unported = dict(
            stage_depth=stage_depth, prefix_cache_mb=prefix_cache_mb,
            prefill_chunk=prefill_chunk, overload=overload,
            round_timeout_ms=round_timeout_ms, slo_ttft_ms=slo_ttft_ms,
            slo_cadence_ms=slo_cadence_ms, slo_target=slo_target,
            flight_recorder=flight_recorder, spec_k=spec_k, draft=draft,
            draft_decoder=draft_decoder, capture_dir=capture_dir, tp=tp,
            mesh=mesh)
        if weight_dtype is not None:
            decoder_kwargs.setdefault("weight_dtype", weight_dtype)
        if attn_impl is not None:
            decoder_kwargs.setdefault("attn_impl", attn_impl)
        dec = Decoder.from_checkpoint(prefix, epoch, max_len,
                                      **decoder_kwargs)
        return cls(dec, slots=slots, prefill_buckets=prefill_buckets,
                   max_queue=max_queue, drain_depth=drain_depth,
                   steps_per_round=steps_per_round, **unported)

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
        return len(self._pending)

    @property
    def idle(self):
        return not self._pending and len(self._free) == self.slots \
            and not self._drain

    def submit(self, prompt, max_tokens, eos_id=None, temperature=0.0,
               seed=None, request_id=None, deadline_ms=None,
               ttft_deadline_ms=None, _resume_tokens=(), _trace=None):
        """Queue one generation request; returns its :class:`Request`.

        prompt: 1-D integer sequence, ``1 <= len <= max_len - 1`` and
        within the largest bucket; at most ``max_len - len(prompt)``
        tokens come back. ``eos_id`` stops generation after it is
        emitted. ``temperature=0`` is greedy; > 0 samples with ``seed``
        (drawn from a counter when omitted). A full queue raises.
        ``deadline_ms``, ``ttft_deadline_ms`` (request deadlines),
        ``_resume_tokens`` (a migrated request's tokens) and ``_trace``
        (fleet trace context) raise unless at their defaults: they belong
        to a later slice."""
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
        any workload one decode program, no verify program (speculation
        is a later slice), one prefill program per USED bucket, and no
        copy program (the prefix cache is a later slice). On the card a
        count is a capture; on the CPU, a program's first run."""
        out = {"decode": 0, "verify": 0, "prefill": {}, "copy": {}}
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

    def _program(self, tag):
        """The program of ``tag`` (``"decode"`` or ``("prefill", b)``),
        built at its first use."""
        prog = self._programs.get(tag)
        if prog is None:
            if tag == "decode":
                fn, operands = self._decode_fn, {}
            else:
                bucket = tag[1]
                ops = torch.zeros(bucket + _N_SCALARS, dtype=torch.int64,
                                  device=self.device)
                fn = functools.partial(self._prefill_fn, bucket, ops)
                operands = {"ops": ops}
            prog = self._programs[tag] = Program(
                fn, operands, mutable=self._state(),
                name="InferenceEngine %s program" % (tag,), tag=tag,
                log=self._compile_log, device=self.device)
        return prog

    def _prefill_fn(self, bucket, ops):
        """The prefill program of ``bucket``: ``ops`` holds the padded
        prompt, then the slot, the true length, the EOS id (-1: none), the
        slot's last position, the seed, the temperature's float32 bits and
        the chunk start. The walk runs at b=1 over the staging cache; its
        rows ``[start, start + bucket)`` go into the slot's rows, and the
        slot's state is set from the first token, picked at the last real
        position, and its row of uniform draws from the seed. Returns that
        token [1]."""
        dec = self._dec
        slot, true_len, eos, lastp, seed, tbits, start = (
            ops[bucket + i:bucket + i + 1] for i in range(_N_SCALARS))
        temp = tbits.to(torch.int32).view(torch.float32)
        logits, _ = dec._run(self._params, self._aux, self._stage,
                             start.to(torch.int32), ops[None, :bucket],
                             mm_impl=self.matmul_impl)
        rows = start + torch.arange(bucket, device=ops.device)
        dec.slot_update(self._caches, slot, self._stage, rows)
        total = start + true_len
        draws = uniform_draw(seed, torch.arange(self.max_len,
                                                device=ops.device))
        t0 = sample_tokens(logits[0].index_select(0, true_len - 1), temp,
                           draws.index_select(0, total))
        for buf, val in ((self._pos, total), (self._tok, t0),
                         (self._live, (t0 != eos) & (total < lastp)),
                         (self._eos, eos), (self._last, lastp),
                         (self._temp, temp), (self._uniform, draws[None])):
            buf.index_copy_(0, slot, val.to(buf.dtype))
        return t0

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

    def _prefill(self, req, slot):
        """Prefill ``req``'s prompt into ``slot`` (padded to its bucket)
        through the bucket's program: one operand copy and one run. The
        first token stays on the card until drained (a copy: the next
        run of the program overwrites its output)."""
        p = len(req.prompt)
        bucket = self._bucket_for(p)
        ops = np.zeros(bucket + _N_SCALARS, np.int64)
        ops[:p] = req.prompt
        # the slot's last position: prompt + budget - 1, within the cache
        lastp = min(p + req.limit - 1, self.max_len - 1)
        eos = -1 if req.eos_id is None else req.eos_id
        tbits = int(np.float32(req.temperature).view(np.int32))
        seed = (req.seed + 2 ** 63) % 2 ** 64 - 2 ** 63   # as int64
        ops[bucket:] = (slot, p, eos, lastp, seed, tbits, 0)
        t0 = self._program(("prefill", bucket))(ops=ops).clone()
        self._drain.append(("prefill", req, slot, t0))
        self.stats["prefills"] += 1

    def _admit(self):
        """Fill free slots from the queue, between decode rounds."""
        admitted = 0
        while self._free and self._pending:
            req = self._pending.popleft()
            slot = self._free.popleft()
            req.t_admit = time.perf_counter()
            self._prefill(req, slot)
            admitted += 1
        return admitted

    def _decode_round(self):
        """One run of the decode program. Returns its [steps, S] tokens,
        copied out of the program's output (up to ``drain_depth`` rounds
        wait to be drained, and the next run overwrites it)."""
        block = self._program("decode")().clone()
        self.stats["steps"] += 1
        return block

    def _push_token(self, req, slot, t, now):
        if t < 0:
            raise MXNetError("InferenceEngine: drained a token from a "
                             "slot the card had retired")
        req.tokens.append(int(t))
        if req.t_first is None:
            req.t_first = now
        self.stats["tokens"] += 1
        hit_eos = req.eos_id is not None and t == req.eos_id
        if hit_eos or len(req.tokens) >= req.limit:
            req.done = True
            req.t_done = now
            req.retire_reason = "eos" if hit_eos else "length"
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
        rows = entry[1].cpu().numpy()          # [steps_per_round, S]
        for row in rows:
            for s in range(self.slots):
                req = self._mirror[s]
                if req is not None:
                    self._push_token(req, s, int(row[s]), now)

    def step(self):
        """One scheduling round: admit queued requests into free slots,
        run one decode round if any slot is occupied, then drain the
        token vectors that are ``drain_depth`` rounds old (all of them
        once nothing is in flight). Returns the requests that finished
        since the last round, in completion order."""
        self._admit()
        if self.slots - len(self._free) > 0:
            self._drain.append(("step", self._decode_round()))
        busy = self.slots - len(self._free) > 0 or bool(self._pending)
        while len(self._drain) > (self._drain_depth if busy else 0):
            self._drain_one()
        done, self._done_buf = self._done_buf, []
        return done
