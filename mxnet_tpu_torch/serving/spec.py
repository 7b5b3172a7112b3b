"""Host-side drafter for speculative decoding.

Counterpart of ``mxnet_tpu/serving/spec.py`` ``NgramDrafter``, line for
line. Speculative decoding splits token generation into a cheap PROPOSE
step and an exact VERIFY step: a drafter guesses the next ``k`` tokens
of a sequence, the target model scores all ``k`` positions in ONE
chunked decode run (``Decoder.verify_step_slots``), and the verified
prefix — every drafted token the target itself would have emitted,
plus the target's one corrected token — is accepted. Because the
target gates every emitted token, outputs equal plain decoding's no
matter what the drafter proposes; a bad drafter only costs speed,
never correctness (Leviathan et al. 2023).

:class:`NgramDrafter` is a prompt-lookup / n-gram drafter (the
PLD/lookahead family) — no second model, no device op: it proposes the
continuation that followed the longest matching suffix of the request's
own ``prompt + emitted`` history. The model-based drafter (a small draft
LM sharing the slot-paged cache layout) runs on the device —
``Decoder.draft_propose_slots`` — scheduled by the engine; see
``InferenceEngine(draft="model")``.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["NgramDrafter"]


class NgramDrafter:
    """Prompt-lookup (n-gram) drafter over one request's token history.

    Pure host-side state machine: ``context`` is the request's
    ``prompt + emitted tokens`` (the engine appends each drained
    token); :meth:`propose` returns up to ``k`` draft tokens by suffix
    matching — for n from ``max_ngram`` down to ``min_ngram``, find the
    LATEST earlier occurrence of the current n-token suffix and
    propose the tokens that followed it. Deterministic: the same
    context always proposes the same draft (the engine's byte-identity
    does not depend on it — verification gates every token — but
    determinism keeps accept-rate metrics reproducible).

    ``state()`` / ``from_state()`` round-trip the drafter through plain
    JSON (the context is derivable from the request's prompt + emitted
    tokens, so a restore can also just rebuild it — the round-trip
    exists so external schedulers can persist drafters standalone).
    """

    def __init__(self, context=(), max_ngram=3, min_ngram=1):
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        if self.min_ngram < 1 or self.max_ngram < self.min_ngram:
            raise MXNetError(
                "NgramDrafter: need 1 <= min_ngram <= max_ngram, got "
                "min_ngram=%r max_ngram=%r" % (min_ngram, max_ngram))
        self._ctx = []
        # incremental n-gram index: for each n, gram -> (latest,
        # second-latest) start positions. propose() is O(max_ngram)
        # instead of re-scanning the whole context per call — this
        # runs per slot per decode round on the serving hot path, and
        # a backward scan would grow linearly with each request's
        # output. Second-latest matters because the query suffix is
        # itself the latest occurrence of its own gram.
        self._latest = [None] + [dict()
                                 for _ in range(self.max_ngram)]
        self._prev = [None] + [dict() for _ in range(self.max_ngram)]
        for t in context:
            self.append(t)

    def __len__(self):
        return len(self._ctx)

    def append(self, token):
        """One more emitted token (the engine calls this per drained
        token, keeping the context current through multi-token
        speculative drains)."""
        ctx = self._ctx
        ctx.append(int(token))
        j = len(ctx) - 1
        for n in range(1, self.max_ngram + 1):
            i = j - n + 1
            if i < 0:
                break
            gram = tuple(ctx[i:j + 1])
            old = self._latest[n].get(gram)
            if old is not None:
                self._prev[n][gram] = old
            self._latest[n][gram] = i

    def extend(self, tokens):
        for t in tokens:
            self.append(t)

    def propose(self, k):
        """Up to ``k`` draft tokens continuing the current context
        (always ``k`` on a match, possibly none).

        For n = ``max_ngram`` .. ``min_ngram``: take the last n tokens
        as the query suffix and scan for its LATEST earlier occurrence
        (an occurrence must leave at least one following token). The
        first n that matches wins — longer suffixes are stronger
        evidence. The proposal walks the tokens that followed the
        match; when the walk reaches the context end it steps back by
        the match's implied period and keeps going — a match at
        distance p from the suffix hypothesizes "the sequence repeats
        with period p", and extending the cycle is what keeps
        proposals ``k`` long on periodic tails (a LATEST-match run of
        one token, e.g. ``...c c c c``, would otherwise propose a
        single ``c`` and cap acceptance at 1 however large ``k``
        is)."""
        k = int(k)
        ctx = self._ctx
        L = len(ctx)
        if k < 1 or L < 2:
            return []
        for n in range(min(self.max_ngram, L - 1),
                       self.min_ngram - 1, -1):
            gram = tuple(ctx[L - n:])
            # the index's latest entry for the query gram is the query
            # suffix itself (appended last); the second-latest is the
            # latest EARLIER occurrence the scan used to find — and
            # any earlier start i <= L-n-1 leaves >= 1 follower token
            i = self._latest[n].get(gram)
            if i == L - n:
                i = self._prev[n].get(gram)
            if i is None or i + n >= L:
                continue
            period = L - n - i         # match-to-suffix distance
            out = []
            j = i + n
            for _ in range(k):
                if j >= L:
                    j -= period        # continue the cycle
                out.append(ctx[j])
                j += 1
            return out
        return []

    def state(self):
        """Plain-JSON snapshot of the drafter."""
        return {"context": list(self._ctx),
                "max_ngram": self.max_ngram,
                "min_ngram": self.min_ngram}

    @classmethod
    def from_state(cls, st):
        return cls(st["context"], max_ngram=st["max_ngram"],
                   min_ngram=st["min_ngram"])
