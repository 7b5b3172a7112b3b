"""Deterministic serving replay: the playback half of the serving time
machine.

Counterpart of the JAX package's ``tools/replay_serving.py`` (library and
CLI): ``python -m mxnet_tpu_torch.serving.replay CAPTURE.jsonl
--checkpoint PREFIX ...``, the same flags, plus ``--device`` (default
``cuda:0``; ``cpu`` runs the engines on the host). ``--tp N`` replays on a
tensor-parallel engine of N ranks (``--tp 1`` unshards a tp capture):
greedy streams do not depend on the degree, so ``--verify`` stays clean.
With ``--device`` the ranks all run on that device; without it, on the
visible cards. A capture of an expert-parallel engine (``ep`` in its
geometry) replays at its ``ep`` on ranks of the same device.

A capture (``MXNET_SERVING_CAPTURE_DIR`` /
``InferenceEngine(capture_dir=...)``, either package's) holds everything a
request's output is a function of — prompt tokens, token budget, eos id,
and the sampling identity ``(seed, temperature)`` — plus the arrival
times and the engine geometry. Because the engine's outputs are
byte-identical across admission orders, speculation, chunking, prefix
hits and snapshot/restore, replaying those submits on a FRESH engine
reproduces the captured tokens exactly; ``--verify`` asserts it. Greedy
captures verify across packages; sampled ones only within the package
that captured them (the two draw differently). ``--weight-dtype int8``
replays onto a quantized-weight engine: the numerics change, so
``--verify`` switches to the prefix-equality mode automatically.

Usage::

    # validate a config change against captured traffic, byte-exact
    python -m mxnet_tpu_torch.serving.replay CAPTURE.jsonl \\
        --checkpoint ckpt/lm --epoch 3 --verify --prefill-chunk 128

    # as-fast-as-possible capacity read instead of recorded pacing
    python -m mxnet_tpu_torch.serving.replay CAPTURE.jsonl \\
        --checkpoint ckpt/lm --epoch 3 --timing max

    # the rolling-restart drill: replay through a 2-replica fleet,
    # drain-and-replace each replica mid-replay, byte-verify
    python -m mxnet_tpu_torch.serving.replay CAPTURE.jsonl \\
        --checkpoint ckpt/lm --epoch 3 --verify \\
        --replicas 2 --rolling-restart

``--timing recorded`` (default) re-paces submissions at the captured
inter-arrival gaps; ``--timing max`` submits as fast as backpressure
allows. Deadlines are NOT replayed (they are wall-clock properties of the
original run, not of the request content) — deadline-retired captures
replay to their full continuation, and ``--verify`` checks byte-identity
only for requests the capture saw complete normally (``eos``/``length``),
prefix-matching the partial tokens of the rest.

Exit status: non-zero when ``--verify`` finds any mismatch.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .capture import load_capture

__all__ = ["build_engine", "recorded_latency", "rolling_restart",
           "replay", "role_report", "main"]

# capture-header keys that must NOT feed the replay engine's
# constructor: max_len belongs to the Decoder, capture_dir would
# re-capture, engine_id/migrated_from are the CAPTURED run's
# identity/provenance — replay engines get fresh ids (a fleet replay
# builds N engines from one header; cloned ids would collide) — and
# role is a TOPOLOGY axis, not request content: a capture recorded on
# a prefill specialist replays fine on a unified engine (outputs are
# role-independent by the disaggregation contract), and ``--roles``
# decides the replay topology explicitly
_NON_CTOR_KEYS = ("max_len", "capture_dir", "engine_id",
                  "migrated_from", "role")


def build_engine(cap, decoder, **overrides):
    """Rebuild the captured engine geometry over ``decoder`` (the same
    weights), with ``overrides`` applied — the ``--slots/--spec-k/...``
    config axes. Replay engines do not re-capture unless an override
    asks for it. A capture's ``attn_impl="dense"`` (the JAX engine's
    default) is honoured over a dense ``decoder`` and gives way to
    ``"paged"`` over a paged one, the port's default: the attention read
    is not request content."""
    from .engine import InferenceEngine

    cfg = {k: v for k, v in cap["engine"].items()
           if k not in _NON_CTOR_KEYS}
    cfg["prefill_buckets"] = tuple(cfg["prefill_buckets"])
    if cfg.get("attn_impl") == "dense" and decoder._attn_impl == "paged":
        cfg["attn_impl"] = "paged"
    cfg.update(overrides)
    return InferenceEngine(decoder, **cfg)


def _percentile(xs, q):
    return round(float(np.percentile(xs, q)), 3) if xs else None


def _latency_summary(ttft, cadence):
    return {
        "ttft_p50_ms": _percentile(ttft, 50),
        "ttft_p99_ms": _percentile(ttft, 99),
        "cadence_p50_ms": _percentile(cadence, 50),
        "cadence_p99_ms": _percentile(cadence, 99),
    }


def recorded_latency(cap):
    """The captured run's own latency summary (from the retire
    records) — what the replay's numbers diff against."""
    ttft = [r["ttft_ms"] for r in cap["retires"].values()
            if r.get("ttft_ms") is not None]
    cadence = [r["cadence_ms"] for r in cap["retires"].values()
               if r.get("cadence_ms") is not None]
    return _latency_summary(ttft, cadence)


def rolling_restart(router, cap, mkreplica, per_role=False):
    """An ``on_round`` hook that drains-and-replaces every replica of
    ``router`` in turn while the capture replays: replica ``k`` is
    drained (in-flight requests migrate live to its peers) once
    ``(k+1)/(N+1)`` of the captured submits are in, and a fresh
    ``mkreplica()`` successor joins the rotation — the
    zero-failed-request rolling-restart drill. Byte-identity under
    ``--verify`` is the acceptance bar: migration must not change a
    single token.

    ``per_role=True`` (a ``--roles`` fleet) calls
    ``mkreplica(role=...)`` with the drained replica's ORIGINAL role
    so a restarted prefill specialist is replaced by a prefill
    specialist — restarts must not silently erode the disaggregated
    topology. Roles are snapshotted here, not read at drain time:
    draining one side of a 1P+1D fleet promotes the survivor to
    unified (the empty-phase fallback), and a post-promotion read
    would replace the original specialist with a unified replica."""
    total = max(1, len(cap["submits"]))
    rids = router.replica_ids(live_only=True)
    roles = [getattr(router.replica(r), "role", "unified")
             for r in rids] if per_role else None
    milestones = [(k + 1) * total // (len(rids) + 1)
                  for k in range(len(rids))]
    state = {"next": 0}

    def on_round(submitted, _engine):
        k = state["next"]
        if k < len(milestones) and submitted >= max(1, milestones[k]):
            state["next"] += 1
            router.drain(rids[k])
            if per_role:
                router.add_replica(mkreplica(role=roles[k]))
            else:
                router.add_replica(mkreplica())
    return on_round


def replay(cap, engine, timing="recorded", verify=False,
           verify_mode="auto", on_round=None):
    """Replay a loaded capture on ``engine``; returns the report dict.

    ``timing="recorded"`` paces submissions at the captured arrival
    offsets (wall clock from replay start); ``"max"`` submits as fast
    as backpressure allows. ``verify=True`` byte-compares each
    replayed output against the captured tokens: full equality where
    the capture retired normally (``eos``/``length``), prefix
    equality where it was cut short host-side (deadline/cancel/shed —
    the replay generates the full continuation the cut run only
    started).

    ``verify_mode``: ``"exact"`` is the byte-identity contract above.
    ``"prefix"`` is the tolerance mode for QUANTIZED replays of a
    float capture (or vice versa — ``--weight-dtype`` changes the
    numerics, so byte-identity is no longer the contract): every
    request verifies by the host-cut rule — the CAPTURED stream must
    be a prefix of the replayed one (argmax-stable configs agree in
    full; the first genuine argmax flip differs at the divergence
    point and reports as a mismatch, and a replayed stream cut short
    host-side fails rather than passing vacuously on the shorter
    common prefix). ``"auto"`` (default) picks ``"prefix"`` exactly
    when the engine's ``weight_dtype`` differs from the capture
    header's, else ``"exact"``.

    ``engine`` may be a :class:`~mxnet_tpu_torch.serving.FleetRouter` (it
    mirrors the driving surface) — a capture replays through a whole
    fleet unchanged. ``on_round(submitted, engine)`` is called once
    per drive-loop iteration with the number of submits admitted so
    far: the hook point for mid-replay operations like
    :func:`rolling_restart`."""
    if timing not in ("recorded", "max"):
        raise ValueError("timing must be 'recorded' or 'max', got %r"
                         % (timing,))
    if verify_mode not in ("auto", "exact", "prefix"):
        raise ValueError("verify_mode must be 'auto', 'exact' or "
                         "'prefix', got %r" % (verify_mode,))
    if verify_mode == "auto":
        cap_wd = cap["engine"].get("weight_dtype", "float")
        verify_mode = "prefix" \
            if getattr(engine, "weight_dtype", "float") != cap_wd \
            else "exact"
    submits = sorted(cap["submits"], key=lambda r: r["t"])
    handles = []                      # (record, Request) pairs
    t0 = time.perf_counter()
    i = 0
    while i < len(submits) or not engine.idle:
        now = time.perf_counter() - t0
        if timing == "recorded" and i < len(submits) and engine.idle \
                and submits[i]["t"] > now:
            # nothing resident and the next captured arrival is in
            # the future: sleep toward it instead of busy-spinning
            # step() through a sparse capture's inter-burst gaps
            # (50 ms cap keeps pacing accurate)
            time.sleep(min(submits[i]["t"] - now, 0.05))
            now = time.perf_counter() - t0
        while i < len(submits) \
                and engine.queued() < engine.max_queue \
                and (timing == "max" or submits[i]["t"] <= now):
            rec = submits[i]
            kw = {}
            if rec.get("trace_id") is not None \
                    and not hasattr(engine, "replica_ids"):
                # preserve the captured fleet identity on plain-engine
                # replays; a FleetRouter mints its own trace context
                kw["_trace"] = (rec["trace_id"], rec.get("hop", 1))
            req = engine.submit(
                np.asarray(rec["prompt"], np.int32),
                max_tokens=rec["max_tokens"],
                eos_id=rec.get("eos_id"),
                temperature=rec.get("temperature", 0.0),
                seed=rec.get("seed"),
                request_id=rec["id"],
                _resume_tokens=tuple(rec.get("resume_tokens", ())),
                **kw)
            handles.append((rec, req))
            i += 1
        engine.step()
        if on_round is not None:
            on_round(i, engine)
    dt = time.perf_counter() - t0

    toks = sum(len(h.tokens) - h.resumed for _, h in handles)
    ttft = [(h.t_first - h.t_submit) * 1e3 for _, h in handles
            if h.t_first is not None]
    cadence = [(h.t_done - h.t_first)
               / (len(h.tokens) - h.resumed - 1) * 1e3
               for _, h in handles
               if h.t_first is not None and h.t_done is not None
               and len(h.tokens) - h.resumed > 1]
    report = {
        "requests": len(submits),
        "replayed": len(handles),
        "tokens": toks,
        "tokens_per_sec": round(toks / dt, 1) if dt else None,
        "wall_s": round(dt, 3),
        "timing": timing,
        **_latency_summary(ttft, cadence),
        "recorded": recorded_latency(cap),
    }
    if verify:
        verified, prefix_ok, skipped, mismatches = 0, 0, 0, []
        for rec, h in handles:
            want = cap["retires"].get(rec["id"])
            if want is None:
                skipped += 1          # capture died before this retire
                continue
            got = np.asarray(h.tokens, np.int64)
            ref = np.asarray(want["tokens"], np.int64)
            if verify_mode == "prefix":
                # tolerance mode (quantized vs float numerics): the
                # CAPTURED stream must be a prefix of the replayed
                # one — the host-cut rule applied to every request.
                # Argmax-stable configs agree in full (same eos and
                # budget force equal lengths for normal retires); a
                # genuine argmax flip differs at the divergence point
                # and reports as a mismatch; a replayed stream that
                # stops SHORT of the capture was cut host-side, not
                # quantization-diverged — also a mismatch (a bare
                # common-prefix check would pass it vacuously)
                ok = len(ref) <= len(got) \
                    and bool((got[:len(ref)] == ref).all())
                prefix_ok += ok
            elif want["reason"] in ("eos", "length"):
                ok = got.shape == ref.shape and bool((got == ref).all())
                verified += ok
            else:
                # host-cut capture: the replayed run must CONTAIN the
                # cut run's tokens as a prefix
                ok = len(ref) <= len(got) \
                    and bool((got[:len(ref)] == ref).all())
                prefix_ok += ok
            if not ok:
                mismatches.append({
                    "id": rec["id"], "reason": want["reason"],
                    "captured": len(ref), "replayed": len(got)})
        report["verified"] = verified
        report["verified_prefix"] = prefix_ok
        report["verify_skipped"] = skipped
        report["verify_mode"] = verify_mode
        report["mismatches"] = mismatches
    return report


def role_report(cap, roles_pd=None):
    """Role round-trip: the capture header records the
    source engine's role (next to engine_id/migrated_from). Returns
    ``(captured_role, note)`` where ``note`` is non-None when a
    SPECIALIST capture is being replayed without a role topology —
    byte-identical either way by the disaggregation contract, but the
    report must say the topology changed rather than stay silent."""
    role = cap["engine"].get("role", "unified")
    note = None
    if role != "unified" and not roles_pd:
        note = ("capture was recorded on a %s-role specialist but "
                "replayed on a unified topology — byte-identical by "
                "the disaggregation contract; pass --roles to "
                "reproduce the captured topology" % role)
    return role, note


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.serving.replay",
        description="Replay a serving traffic capture on a fresh "
                    "engine of the PyTorch port")
    ap.add_argument("capture", help="mx_capture_*.jsonl file")
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint prefix (prefix-symbol.json + "
                         "prefix-NNNN.params) — the SAME weights the "
                         "capture was served with")
    ap.add_argument("--epoch", type=int, default=0)
    ap.add_argument("--max-len", type=int, default=None,
                    help="decoder max_len (default: the capture "
                         "header's)")
    ap.add_argument("--timing", choices=("recorded", "max"),
                    default="recorded")
    ap.add_argument("--verify", action="store_true",
                    help="assert replayed outputs byte-match the "
                         "captured tokens (exit 1 on any mismatch)")
    # config-override axes: one capture validates any engine-config
    # change offline
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--steps-per-round", type=int, default=None)
    ap.add_argument("--spec-k", type=int, default=None)
    ap.add_argument("--draft", default=None,
                    choices=("off", "ngram", "model"))
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--prefix-cache-mb", type=float, default=None)
    ap.add_argument("--attn-impl", default=None,
                    choices=("dense", "paged"))
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel degree override (default: the "
                         "capture's; 1 = unshard a tp capture); the ranks "
                         "run on --device, else on the visible cards")
    ap.add_argument("--weight-dtype", default=None,
                    choices=("float", "int8"),
                    help="weight-storage override: replay the capture "
                         "on an int8-weight engine. --verify switches to "
                         "prefix-equality/tolerance mode when this "
                         "differs from the captured dtype (exact for "
                         "matching dtypes); --verify-mode overrides")
    ap.add_argument("--verify-mode", default="auto",
                    choices=("auto", "exact", "prefix"),
                    help="--verify comparison mode (default auto: "
                         "exact unless the weight dtype changed)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="replay through a FleetRouter over N replica "
                         "engines of the captured geometry instead of "
                         "one engine; health-driven + prefix-"
                         "affinity placement decides where each "
                         "captured request lands")
    ap.add_argument("--roles", default=None, metavar="PxD",
                    help="disaggregated replay topology: P prefill-"
                         "role + D decode-role replicas (e.g. "
                         "'--roles 2x2'). Composes "
                         "with --replicas (adds N unified replicas to "
                         "the same fleet), --rolling-restart "
                         "(restarted specialists keep their role) and "
                         "every engine-config override; "
                         "--verify must stay clean — disaggregation "
                         "is byte-invisible")
    ap.add_argument("--rolling-restart", action="store_true",
                    help="with --replicas/--roles: drain and replace "
                         "every replica in turn mid-replay (in-flight "
                         "requests migrate live to peers) — the "
                         "zero-failed-request restart drill; combine "
                         "with --verify for the byte-identity bar")
    ap.add_argument("--compute-dtype", default=None,
                    help="decoder compute dtype (e.g. bfloat16)")
    ap.add_argument("--device", default=None,
                    help="the engines' device (default cuda:0; cpu runs "
                         "them on the host)")
    args = ap.parse_args(argv)

    from ..parallel import Decoder, build_mesh, model_parallel_mesh

    cap = load_capture(args.capture)
    max_len = args.max_len or cap["engine"].get("max_len")
    if not max_len:
        ap.error("capture header carries no max_len; pass --max-len")
    # decoder pinned float regardless of MXNET_SERVING_WEIGHT_DTYPE:
    # the capture header (or --weight-dtype) decides the ENGINE's
    # dtype, and an env-quantized decoder could not serve a
    # float-header capture (the float weights are gone)
    deckw = {"cache_block": None, "weight_dtype": "float",
             "device": args.device}
    if args.attn_impl == "dense":
        # the engine's dense read needs a decoder built dense
        deckw["attn_impl"] = "dense"
    if args.compute_dtype:
        deckw["compute_dtype"] = args.compute_dtype

    def mkdec():
        return Decoder.from_checkpoint(args.checkpoint, args.epoch,
                                       max_len, **deckw)
    overrides = {k: v for k, v in (
        ("slots", args.slots),
        ("steps_per_round", args.steps_per_round),
        ("spec_k", args.spec_k),
        ("draft", args.draft),
        ("prefill_chunk", args.prefill_chunk),
        ("prefix_cache_mb", args.prefix_cache_mb),
        ("attn_impl", args.attn_impl),
        ("weight_dtype", args.weight_dtype),
    ) if v is not None}
    tp = args.tp if args.tp is not None else cap["engine"].get("tp", 1)
    if args.tp is not None:
        overrides["tp"] = tp
    ep = int(cap["engine"].get("ep", 1) or 1)
    if tp > 1 and args.device is not None:
        # the ranks of a single-controller mesh on the one device asked for
        overrides["mesh"] = build_mesh(
            {"expert": ep, "model": tp}, [args.device] * (ep * tp)) \
            if ep > 1 else model_parallel_mesh(
                tp, devices=[args.device] * tp)
    roles_pd = None
    if args.roles:
        try:
            p, d = (int(x) for x in args.roles.lower().split("x"))
        except ValueError:
            p = d = 0
        if p < 1 or d < 1:
            ap.error("--roles takes PxD with P,D >= 1 (e.g. 2x2)")
        roles_pd = (p, d)
    on_round = None
    if args.replicas or roles_pd:
        from .fleet import FleetRouter

        def mkreplica(role="unified"):
            return build_engine(cap, mkdec(), role=role, **overrides)

        engines = [mkreplica() for _ in range(args.replicas or 0)]
        if roles_pd:
            engines += [mkreplica(role="prefill")
                        for _ in range(roles_pd[0])]
            engines += [mkreplica(role="decode")
                        for _ in range(roles_pd[1])]
        engine = FleetRouter(engines)
        if args.rolling_restart:
            on_round = rolling_restart(engine, cap, mkreplica,
                                       per_role=bool(roles_pd))
    elif args.rolling_restart:
        ap.error("--rolling-restart needs --replicas or --roles")
    else:
        engine = build_engine(cap, mkdec(), **overrides)
    report = replay(cap, engine, timing=args.timing,
                    verify=args.verify, verify_mode=args.verify_mode,
                    on_round=on_round)
    report["overrides"] = {k: v for k, v in overrides.items()
                           if k != "mesh"}
    captured_role, note = role_report(cap, roles_pd)
    report["captured_role"] = captured_role
    if note:
        report["role_note"] = note
    if args.replicas or roles_pd:
        report["fleet"] = dict(engine.stats)
        if roles_pd:
            report["roles"] = "%dx%d" % roles_pd
    print(json.dumps(report, sort_keys=True))
    if args.verify and report["mismatches"]:
        print("REPLAY VERIFY FAILED: %d mismatch(es)"
              % len(report["mismatches"]), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
