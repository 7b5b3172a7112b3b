"""Data staging: the depth-k staging helper.

Counterpart of ``mxnet_tpu/io.py``'s :class:`StagedStream` in its inline
mode, which the serving engine's prompt stager runs
(``mxnet_tpu_torch/serving/engine.py``: padded prompts go host -> device
``stage_depth`` requests ahead of admission). The pipeline-thread mode
and the DataIters belong to a later slice of the port.
"""
from __future__ import annotations

import collections

from .base import later_slice

__all__ = ["StagedStream"]


class StagedStream:
    """Pull items from a source, run ``place`` on each (typically an
    asynchronous host -> device copy, so that the transfer proceeds while
    earlier items are consumed), and keep up to ``depth`` placed items
    ready ahead of the consumer.

    ``source``: an object with ``.next()`` raising ``StopIteration`` at
    the end and ``.reset()``.

    Items are pulled and placed inline when the consumer asks for the
    NEXT item: overlap comes from asynchronous copies, so the source
    itself must be cheap. Iteration ends at source exhaustion and then
    RE-ARMS (a new for-loop resumes); items staged before a consumer
    ``break`` are served on resume, never dropped.

    ``live_source=True``: the source may GAIN items at any time (the
    serving engine's pending queue), so exhaustion is never latched —
    every fill re-probes the source, and a ``next()`` right after new
    items arrive stages them immediately. The default (False) latches
    until the staged queue drains, which epoch iterators require: an
    exhausted one must not be pulled again mid-drain.

    ``thread=True`` (pulls and placement on a pipeline thread) raises: it
    belongs to a later slice of the port.
    """

    def __init__(self, source, place=None, depth=2, thread=False,
                 live_source=False):
        if thread:
            raise later_slice("StagedStream", "thread=True")
        self._source = source
        self._placefn = place if place is not None else (lambda x: x)
        self._depth = max(1, int(depth))
        self._live = bool(live_source)
        self._queue = collections.deque()
        self._exhausted = False

    # -- consumer side --------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        self._fill()
        if not self._queue:
            self._exhausted = False  # re-arm: caller resets + re-iterates
            raise StopIteration
        out = self._queue.popleft()
        self._fill()  # dispatch i+1's placement before handing back i
        return out

    def staged(self):
        """Items pulled from the source and staged but not yet handed to
        the consumer."""
        return len(self._queue)

    def _fill(self):
        while not self._exhausted and len(self._queue) < self._depth:
            try:
                item = self._source.next()
            except StopIteration:
                if not self._live:
                    self._exhausted = True
                return
            self._queue.append(self._placefn(item))

    def prune(self, pred):
        """Drop staged items matching ``pred`` and return them — the
        serving engine retires queue-waiting requests (deadline expiry,
        cancellation, load shedding) that its stager already pulled and
        placed, without disturbing the rest of the staged order."""
        kept, dropped = [], []
        for x in self._queue:        # single pass: pred may be stateful
            (dropped if pred(x) else kept).append(x)
        if dropped:
            self._queue.clear()
            self._queue.extend(kept)
        return dropped

    # -- lifecycle ------------------------------------------------------
    def reset(self):
        """Discard staged items (stale after a source rewind) and rewind
        the source."""
        self._queue.clear()
        self._source.reset()
        self._exhausted = False

    def close(self):
        """Nothing to stop: the inline mode owns no thread."""
