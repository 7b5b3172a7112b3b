"""KV handoff between role-specialized serving engines.

Counterpart of ``mxnet_tpu/serving/handoff.py``. Disaggregated
prefill/decode serving splits the two phases of a request across
SPECIALIST engines: a prefill-role engine runs admission + bucketed/chunked
prefill only and then hands the finished request — its live KV rows,
sampling identity, and the first emitted token — to a decode-role engine,
which continues it byte-identically to what one unified engine would have
produced. Long-prompt prefill rounds then never share a dispatch queue
with anyone's decode cadence.

This module is the WIRE FORMAT half of that split, free of any scheduler
knowledge:

* :class:`KVHandoff` — one packaged finished prefill. It pins the source
  engine's slot until the router confirms delivery (or gives up and falls
  back to unified serving), exports the slot's KV rows lazily exactly once
  (retries re-send the cached export rather than touching the source
  cache again), and carries everything the decode side needs to resume:
  prompt, emitted tokens, sampling identity (temperature + resolved
  seed), eos/limit bounds, and the prefill length ``P`` whose rows the
  payload covers.
* :func:`pack_rows` / :func:`unpack_rows` — the transfer encoding over the
  port's cache-row tree (``Decoder.slot_prefix_rows``: a list, one entry a
  node, of tuples of ``[1, rows, ...]`` tensors; any nesting of lists,
  tuples and dicts works). ``native`` ships rows at cache dtype, bf16
  included, bit for bit (CPU tensors: numpy has no bfloat16); ``int8``
  quantizes each float leaf symmetric over every axis but axis 0 — what
  the JAX package's ``_quantize`` computes. An exported leaf is ``[1, P,
  ...]``, so that is ONE amax/127 scale a leaf (the JAX docstring's "per
  row" holds only for a leaf whose axis 0 is the row axis); the port
  reproduces the arithmetic, not the docstring, and its q and scale equal
  the JAX ``pack_rows``' bit for bit on the same rows. Integer leaves (an
  int8 KV cache) pass through; its f32 row-scale leaves are float and are
  quantized too, as in the JAX package.

A package may carry tokens its decode side still has to REGENERATE: a
resumed request (failover, drain) prefilled on a prefill specialist
prefills its prompt only (the port's ``Request`` says why), so its rows
cover ``P = len(prompt)`` positions and the recorded tokens after the
first are regenerated by the decode engine's rounds, checked, and not
emitted again. ``P`` and the token count say which case a payload is:
the decode side resumes at position ``P`` with the token
``(prompt + tokens)[P]`` pending and regenerates the
``len(prompt) + len(tokens) - 1 - P`` tokens after it (0 for every
payload the JAX package makes).

The scheduler half (role gating, export/import programs, exactly-once
admission) lives in :mod:`.engine`; placement, transport discipline and
failure fallback live in :mod:`.fleet`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["KVHandoff", "pack_rows", "unpack_rows", "HANDOFF_DTYPES"]

HANDOFF_DTYPES = ("native", "int8")


class _Quant:
    """One int8-quantized cache leaf: ``q`` (int8) plus its f32 ``scale``
    (one value an index of axis 0, kept dims). A plain class, a leaf of
    the payload tree."""

    __slots__ = ("q", "scale")

    def __init__(self, q, scale):
        self.q = q
        self.scale = scale

    @property
    def nbytes(self):
        return _nbytes(self.q) + _nbytes(self.scale)

    def __repr__(self):
        return "_Quant(shape=%s, nbytes=%d)" % (tuple(self.q.shape),
                                                self.nbytes)


def _nbytes(t):
    return t.numel() * t.element_size()


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (lists, tuples and dicts nest;
    anything else is a leaf), zipped with trees of the same structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def _quantize(x):
    """Symmetric int8 over every axis but axis 0: amax/127 with a zero
    guard, round half to even, clip — the JAX package's numpy formula in
    f32, bit for bit (``torch.round`` rounds half to even as ``np.rint``
    does, and both divide in f32), on whatever device ``x`` lives."""
    x = x.to(torch.float32)
    dims = tuple(range(1, x.dim()))
    amax = x.abs().amax(dim=dims, keepdim=True) if dims else x.abs()
    scale = amax / 127.0
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return _Quant(q, scale)


def pack_rows(rows, dtype):
    """Encode an exported cache-row tree for transfer.

    ``native`` passes every leaf through as-is; ``int8`` replaces each
    FLOAT leaf (f32/bf16 caches, an int8 cache's row scales) with a
    :class:`_Quant` and leaves integer leaves untouched. Leaves are torch
    tensors (numpy arrays are taken as tensors). Returns ``(payload_tree,
    nbytes)`` where nbytes is what actually ships."""
    if dtype not in HANDOFF_DTYPES:
        raise MXNetError("pack_rows: unknown handoff dtype %r (one of %s)"
                         % (dtype, ", ".join(HANDOFF_DTYPES)))

    def enc_leaf(x):
        x = torch.as_tensor(x)
        if dtype == "int8" and x.is_floating_point():
            return _quantize(x)
        return x

    payload = _tree_map(enc_leaf, rows)
    nbytes = sum(leaf.nbytes if isinstance(leaf, _Quant) else _nbytes(leaf)
                 for leaf in _leaves(payload))
    return payload, int(nbytes)


def unpack_rows(payload, template):
    """Decode a packed payload back to cache-dtype rows. ``template`` is
    any tree of the payload's structure whose leaves carry the destination
    cache dtypes (the importing engine passes its cache tree).
    Dequantized rows land at the template dtype (``q * scale`` in f32,
    then one rounding), so an fp cache that opted into int8 transfer
    absorbs the quantization error once, before the write; integer leaves
    come back bit-exact."""
    def dec(x, ref):
        if isinstance(x, _Quant):
            return (x.q.to(torch.float32) * x.scale).to(ref.dtype)
        return torch.as_tensor(x)

    return _tree_map(dec, payload, template)


class KVHandoff:
    """One finished prefill packaged for delivery to a decode engine.

    Created by the source engine when a prefill-role request's first token
    drains (``InferenceEngine._handoff_prefill``); the slot named here
    stays OUT of the source's free list until :meth:`resolve` runs —
    exactly once, on whichever terminal path the router drives the package
    down (delivered, deduped after a retry, or abandoned to unified
    fallback).
    """

    __slots__ = ("id", "prompt", "tokens", "max_tokens", "eos_id",
                 "temperature", "seed", "prefill_len", "last",
                 "prefill_seq", "slot", "source", "resolved",
                 "t_ready", "trace", "_packed", "_nbytes")

    def __init__(self, engine, req, slot, prefill_len):
        self.id = req.id
        self.prompt = np.asarray(req.prompt, np.int64)
        # every token the request has (recorded ones a resumed request is
        # still regenerating included): the decode side resumes AFTER the
        # one at position prefill_len
        self.tokens = [int(t) for t in req.tokens]
        self.max_tokens = int(req.max_tokens)
        self.eos_id = req.eos_id
        self.temperature = float(req.temperature)
        self.seed = int(req.seed)
        # P: the positions the exported rows cover (what the prefill
        # wrote: the prompt, plus the emitted tokens when they were
        # prefilled too)
        self.prefill_len = int(prefill_len)
        # absolute last position, the prefill program's clamp
        self.last = min(len(self.prompt) + req.limit - 1,
                        engine.max_len - 1)
        self.prefill_seq = np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int64)]
        )[:self.prefill_len]
        self.slot = int(slot)
        self.source = engine
        self.resolved = False
        # fleet trace context ((trace_id, hop) or None) rides the package
        # so the decode side's flight events keep the fleet identity
        self.trace = getattr(req, "trace", None)
        self.t_ready = time.perf_counter()
        self._packed = None
        self._nbytes = 0

    def materialize(self):
        """Export + pack the KV rows, once; cached so a retried or
        re-routed delivery never re-reads the source cache."""
        if self._packed is None:
            rows = self.source._export_rows(self.slot, self.prefill_len)
            self._packed, self._nbytes = pack_rows(
                rows, self.source.handoff_dtype)
        return self._packed

    @property
    def nbytes(self):
        self.materialize()
        return self._nbytes

    def payload(self, with_rows=True):
        """The admission dict ``InferenceEngine.admit_handoff`` takes.
        ``with_rows=False`` ships identity only — the router uses it when
        the target's prefix pool already retains the full prefill, so the
        transfer is skipped entirely."""
        return {
            "id": self.id,
            "prompt": self.prompt,
            "tokens": list(self.tokens),
            "max_tokens": self.max_tokens,
            "eos_id": self.eos_id,
            "temperature": self.temperature,
            "seed": self.seed,
            "prefill_len": self.prefill_len,
            "last": self.last,
            "trace": self.trace,
            "rows": self.materialize() if with_rows else None,
        }

    def resolve(self):
        """Release the source-side slot (exactly once)."""
        self.source._resolve_handoff(self)

    def __repr__(self):
        return ("KVHandoff(id=%r, P=%d, slot=%d, resolved=%s)"
                % (self.id, self.prefill_len, self.slot, self.resolved))
