"""Data iterators and the depth-k staging helper.

Counterpart of ``mxnet_tpu/io.py``: the ``DataIter`` protocol,
``DataBatch`` and ``NDArrayIter`` (l.45-198; the reference's
``python/mxnet/io.py`` NDArrayIter:311), which the trainers' ``fit``
iterates, and :class:`StagedStream` in its inline mode, which ``fit``'s
staged input and the serving engine's prompt stager run. ``NDArrayIter``
takes NDArrays, numpy arrays or torch tensors, and its batches' ``data``
and ``label`` are NDArrays on ``cpu()`` (the host, as the JAX package's
default context): a trainer stages them onto its device.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from .base import later_slice
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataBatch", "DataIter", "NDArrayIter", "StagedStream"]


class DataBatch:
    """One batch: data/label lists of NDArrays, the pad (rows at the end
    that wrap around) and the index."""

    def __init__(self, data, label, pad=None, index=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index


class DataIter:
    """Iterator protocol: provide_data/provide_label/batch_size and
    reset/iter_next/getdata/getlabel/getindex/getpad, with ``next()`` and
    Python iteration."""

    def __init__(self):
        self.batch_size = 0

    def reset(self):
        pass

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


def _host_array(v):
    if isinstance(v, NDArray):
        return v.asnumpy()
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _init_data(data, allow_empty, default_name):
    """Normalize the input to a list of (name, numpy array)."""
    if data is None:
        if not allow_empty:
            raise ValueError("data must not be None")
        data = []
    if isinstance(data, (np.ndarray, torch.Tensor, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise ValueError("data must not be empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, a tensor, numpy.ndarray, "
                        "list or dict")
    return [(k, _host_array(v)) for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (NDArray, numpy or torch).

    ``shuffle`` permutes the rows once, with numpy's global generator (as
    the JAX package does). ``last_batch_handle``: "pad" (the last batch
    wraps around to the first rows, ``pad`` counts them), "discard" (the
    tail is dropped), "roll_over" (the tail rolls over into the next
    epoch)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__()
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data "
                             "size.")
        self.num_source = len(self.data)
        if shuffle:
            idx = np.arange(self.num_data)
            np.random.shuffle(idx)
            self.data = [(k, v[idx]) for k, v in self.data]
            self.label = [(k, v[idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            self.num_data -= self.num_data % batch_size
        self.batch_size = batch_size
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [(k, (self.batch_size,) + v.shape[1:]) for k, v in self.data]

    @property
    def provide_label(self):
        return [(k, (self.batch_size,) + v.shape[1:])
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        if self.cursor >= self.num_data:
            raise ValueError("DataIter needs reset.")
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            rows = [v[self.cursor:end].copy() for _, v in data_source]
        else:
            pad = self.batch_size - self.num_data + self.cursor
            rows = [np.concatenate([v[self.cursor:], v[:pad]], axis=0)
                    for _, v in data_source]
        return [array(r, cpu()) for r in rows]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


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
