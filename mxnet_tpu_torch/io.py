"""Data iterators and the depth-k staging helper.

Counterpart of ``mxnet_tpu/io.py``: the ``DataIter`` protocol,
``DataBatch``, ``NDArrayIter`` (the reference's ``python/mxnet/io.py``
NDArrayIter:311), ``ResizeIter`` and ``PrefetchingIter`` (reference
io.py:112, :166), the idx-ubyte ``MNISTIter`` and ``CSVIter`` (the
reference's ``src/io/iter_mnist.cc``, ``iter_csv.cc``),
:class:`StagedStream` inline or on a pipeline thread, and
:class:`DevicePrefetchIter`, which copies batches to the card on that
thread. The record pipeline (``ImageRecordIter``) lives in
``recordio.py`` and ``image_io.py``.

Batches of the host iterators hold NDArrays on ``cpu()`` (the host, as
the JAX package's default context); a trainer stages them onto its
device, or :class:`DevicePrefetchIter` does it ahead of the consumer: on
its pipeline thread each array goes through pinned memory onto a side
stream, and the consumer's stream waits on the copy's event before it
reads the batch.
"""
from __future__ import annotations

import collections
import gzip
import queue
import struct
import threading
import time

import numpy as np
import torch

from . import telemetry as tele
from .base import MXNetError, later_slice
from .context import Context, cpu, resolve_device
from .ndarray import NDArray, array

# pipeline-thread metrics: fetch = the host work done ON the pipeline
# thread (the wrapped iterator's next() plus the staging transform);
# wait = what the consumer paid because that work was not ready
_TM_FETCH_MS = tele.histogram("io.pipeline_fetch_ms")
_TM_WAIT_MS = tele.histogram("io.pipeline_wait_ms")
_TM_STARVED = tele.counter("io.pipeline_starved")
_TM_BATCHES = tele.counter("io.pipeline_batches")

__all__ = ["MXDataIter", "DataIter", "DataBatch", "NDArrayIter",
           "ResizeIter", "PrefetchingIter", "DevicePrefetchIter",
           "StagedStream", "MNISTIter", "CSVIter"]


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




class ResizeIter(DataIter):
    """Redefine an iterator's epoch as exactly ``size`` batches: a shorter
    epoch stops early, a longer one restarts the wrapped iterator as
    needed. ``reset_internal=False`` leaves the wrapped iterator's
    position alone across our resets."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        for attr in ("provide_data", "provide_label", "batch_size"):
            setattr(self, attr, getattr(data_iter, attr))

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def _draw(self):
        try:
            return self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            return self.data_iter.next()

    def iter_next(self):
        if self.cur >= self.size:
            return False
        self.cur += 1
        self.current_batch = self._draw()
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class _WorkerFailure:
    """An exception that escaped a pipeline worker, carried through the
    response queue so that the consumer raises it (a dead worker would
    otherwise leave the consumer waiting on an empty queue)."""

    def __init__(self, exc):
        import traceback
        self.exc = exc
        self.tb = traceback.format_exc()


class _PipelineWorker(threading.Thread):
    """Depth-k producer for one iterator over a request/response channel:
    the consumer keeps up to ``depth`` fetches outstanding, so the wrapped
    iterator's host work (and an optional ``transform``, e.g. the copy to
    the card) runs while earlier batches are consumed. Behind
    ``PrefetchingIter`` (depth 1) and ``StagedStream(thread=True)``."""

    _FETCH, _RESTART, _QUIT = object(), object(), object()

    def __init__(self, it, depth=1, transform=None):
        super().__init__(daemon=True)
        self._it = it
        self._transform = transform
        self._depth = max(1, int(depth))
        self._requests = queue.Queue()   # unbounded: posting never blocks
        self._results = queue.Queue()
        self._inflight = self._depth
        self._ended = False              # the consumer saw the epoch end
        self.start()
        for _ in range(self._depth):
            self._requests.put(self._FETCH)

    def run(self):
        # latched at the epoch's end: with depth > 1 requests are still
        # outstanding when StopIteration first fires, and they must not
        # touch the iterator again (a roll_over cursor would move twice)
        exhausted = False
        while True:
            req = self._requests.get()
            if req is self._QUIT:
                return
            if req is self._RESTART:
                exhausted = False
                continue
            if exhausted:
                self._results.put(None)
                continue
            try:
                tic = time.perf_counter()
                batch = self._it.next()
                if self._transform is not None:
                    batch = self._transform(batch)
                _TM_FETCH_MS.observe((time.perf_counter() - tic) * 1e3)
            except StopIteration:
                exhausted = True
                batch = None             # the epoch-end marker
            except BaseException as e:   # surfaced, never a hung queue
                exhausted = True
                batch = _WorkerFailure(e)
            self._results.put(batch)

    def take(self):
        """The oldest in-flight batch (None at the epoch's end), posting
        the next request, but not past the epoch's end."""
        if self._ended:
            return None
        tic = time.perf_counter()
        batch = self._results.get()
        if batch is not None and not isinstance(batch, _WorkerFailure):
            # a real batch: waiting for the epoch-end marker or a failure
            # is not starvation
            wait = time.perf_counter() - tic
            _TM_WAIT_MS.observe(wait * 1e3)
            if wait > 1e-3:
                _TM_STARVED.inc()
            _TM_BATCHES.inc()
        if isinstance(batch, _WorkerFailure):
            self._ended = True
            self._absorb()
            raise MXNetError("data pipeline worker failed:\n%s"
                             % batch.tb) from batch.exc
        if batch is None:
            self._ended = True
            self._absorb()
        else:
            self._requests.put(self._FETCH)
        return batch

    def _absorb(self, first=None):
        """Drain the in-flight responses (one, ``first``, already taken);
        returns the first failure among them, which must not be lost."""
        failure = first if isinstance(first, _WorkerFailure) else None
        drained = 1
        while drained < self._inflight:
            got = self._results.get()
            if failure is None and isinstance(got, _WorkerFailure):
                failure = got
            drained += 1
        self._inflight = 0
        return failure

    def restart(self):
        """Absorb the in-flight fetches, rewind the iterator and prime the
        pipeline again; a failure still waiting in the queue is raised."""
        failure = None
        if not self._ended:
            failure = self._absorb(self._results.get())
        # the worker is idle now, so rewinding from this thread is safe
        self._it.reset()
        self._requests.put(self._RESTART)
        self._ended = False
        self._inflight = self._depth
        for _ in range(self._depth):
            self._requests.put(self._FETCH)
        if failure is not None:
            raise MXNetError("data pipeline worker failed:\n%s"
                             % failure.tb) from failure.exc

    def stop(self):
        self._requests.put(self._QUIT)


class PrefetchingIter(DataIter):
    """Host-pipelined prefetcher over one or more iterators (reference
    io.py:166, ``dmlc::ThreadedIter``): batch i+1 is prepared on worker
    threads while batch i is in use. ``rename_data``/``rename_label``
    remap each iterator's names (one dict an iterator)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        self.iters = iters if isinstance(iters, list) else [iters]
        assert self.iters, "PrefetchingIter needs at least one iterator"
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.current_batch = None
        self._workers = [_PipelineWorker(i) for i in self.iters]

    def __del__(self):
        for w in getattr(self, "_workers", []):
            w.stop()

    @staticmethod
    def _combined(provides, renames):
        if renames is None:
            return [entry for p in provides for entry in p]
        return [(r[name], shape) for r, p in zip(renames, provides)
                for name, shape in p]

    @property
    def provide_data(self):
        return self._combined([i.provide_data for i in self.iters],
                              self.rename_data)

    @property
    def provide_label(self):
        return self._combined([i.provide_label for i in self.iters],
                              self.rename_label)

    def reset(self):
        for w in self._workers:
            w.restart()

    def iter_next(self):
        parts = [w.take() for w in self._workers]
        ended = [p is None for p in parts]
        if any(ended):
            assert all(ended), "iterators ended at different batch counts"
            return False
        assert all(p.pad == parts[0].pad for p in parts), \
            "iterators disagree on batch padding"
        self.current_batch = DataBatch(
            [d for p in parts for d in p.data],
            [lab for p in parts for lab in p.label],
            parts[0].pad, parts[0].index)
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class StagedStream:
    """Pull items from a source, run ``place`` on each (typically an
    asynchronous host -> device copy, so that the transfer proceeds while
    earlier items are consumed), and keep up to ``depth`` placed items
    ready ahead of the consumer. Behind ``ParallelTrainer``'s staged
    batches (inline), ``DevicePrefetchIter`` (threaded) and the serving
    engine's prompt stager (inline, ``live_source``).

    ``source``: an object with ``.next()`` raising ``StopIteration`` at
    the end and ``.reset()``.

    ``thread=False``: items are pulled and placed inline when the
    consumer asks for the NEXT item; overlap comes from asynchronous
    copies, so the source itself must be cheap. Iteration ends at source
    exhaustion and then RE-ARMS (a new for-loop resumes); items staged
    before a consumer ``break`` are served on resume, never dropped.

    ``thread=True``: pulls and placement run on a pipeline thread, for
    sources that do real host work (a decode pool, augmentation). After
    exhaustion ``next()`` raises ``StopIteration`` until ``reset()``;
    a failure of the threaded pull surfaces as ``MXNetError``.

    ``live_source=True`` (inline only): the source may GAIN items at any
    time (the serving engine's pending queue), so exhaustion is never
    latched. The default latches until the staged queue drains, which
    epoch iterators require.
    """

    def __init__(self, source, place=None, depth=2, thread=False,
                 live_source=False):
        self._source = source
        self._placefn = place if place is not None else (lambda x: x)
        self._depth = max(1, int(depth))
        self._live = bool(live_source)
        self._threaded = bool(thread)
        if self._threaded:
            self._worker = _PipelineWorker(source, depth=self._depth,
                                           transform=self._placefn)
        else:
            self._queue = collections.deque()
            self._exhausted = False

    # -- consumer side --------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if self._threaded:
            got = self._worker.take()
            if got is None:
                raise StopIteration
            return got
        self._fill()
        if not self._queue:
            self._exhausted = False  # re-arm: caller resets + re-iterates
            raise StopIteration
        out = self._queue.popleft()
        self._fill()  # dispatch i+1's placement before handing back i
        return out

    def staged(self):
        """Items pulled and staged but not yet handed to the consumer
        (inline mode; the threaded pipeline keeps its own count)."""
        return 0 if self._threaded else len(self._queue)

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
        """Drop staged items matching ``pred`` (inline mode only) and
        return them: the serving engine retires queue-waiting requests
        that its stager already pulled and placed, without disturbing
        the rest of the staged order."""
        if self._threaded:
            raise MXNetError("StagedStream.prune: inline mode only "
                             "(threaded staging owns its queue)")
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
        if self._threaded:
            self._worker.restart()   # absorbs in-flight + resets source
            return
        self._queue.clear()
        self._source.reset()
        self._exhausted = False

    def close(self):
        """Stop the pipeline thread (threaded mode; inline owns none)."""
        if self._threaded:
            self._worker.stop()


def _prefetch_device(sharding, mesh, data_axis):
    """The device ``DevicePrefetchIter`` places batches on: ``sharding``
    (a device, its name or a Context), else the device of ``mesh``'s
    ranks in this process (``ParallelTrainer(mesh=)`` takes the batch
    there, the global one or across processes this process's rows, and
    gives each ``data_axis`` rank its rows), else ``cuda:0``."""
    if sharding is None and mesh is not None:
        if data_axis not in mesh.shape:
            raise MXNetError("DevicePrefetchIter: the mesh has no axis %r "
                             "(axes %s)" % (data_axis, list(mesh.shape)))
        devs = {torch.device(d) for d in mesh.local_devices()}
        if len(devs) > 1:
            raise later_slice("DevicePrefetchIter",
                              "a mesh over distinct devices")
        sharding = devs.pop()
    if isinstance(sharding, Context):
        sharding = sharding.torch_device
    return resolve_device(sharding)


class _OnStream:
    """A source whose ``next()`` runs on ``stream`` (the pipeline thread's
    side stream), so a wrapped iterator's copies and kernels stay off the
    consumer's stream."""

    def __init__(self, base, stream):
        self.base = base
        self.stream = stream

    def next(self):
        with torch.cuda.stream(self.stream):
            return self.base.next()

    def reset(self):
        self.base.reset()


def _stage_tensor(t, device):
    """``t`` on ``device``; a host tensor goes through pinned memory and
    copies without blocking (on the caller's current stream). A tensor
    already there is not copied."""
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        pinned.copy_(t)
        return pinned.to(device, non_blocking=True)
    return t.to(device)


def _stage_batch(batch, device, stream):
    """One batch on ``device`` as NDArrays; on a card, copied on
    ``stream`` with an event recorded after the copies (the consumer's
    stream waits on it)."""
    def arrays(vals):
        return [NDArray(_stage_tensor(v._tensor if isinstance(v, NDArray)
                                      else torch.as_tensor(v), device))
                for v in vals]

    if stream is None:
        out = DataBatch(arrays(batch.data), arrays(batch.label), batch.pad,
                        batch.index)
        out._ready = None
        return out
    with torch.cuda.stream(stream):
        out = DataBatch(arrays(batch.data), arrays(batch.label), batch.pad,
                        batch.index)
        ev = torch.cuda.Event()
        ev.record(stream)
    out._ready = ev
    return out


class DevicePrefetchIter(DataIter):
    """Overlapped host -> device staging over any DataIter: a pipeline
    thread pulls batch i+1 from ``base`` and copies it to the device while
    batch i is consumed (the device half of the reference's
    ``iter_prefetcher.h`` double buffer). ``depth`` batches are kept in
    flight.

    ``sharding`` is the ``torch.device`` to place on; ``mesh=`` places
    the batch where ``ParallelTrainer(mesh=)`` takes it, the device of
    the mesh's ranks, whose program gives each ``data_axis`` rank its
    rows (a mesh over distinct devices belongs to a later slice).
    Default: ``cuda:0``.

    On a card the thread runs on a side stream: each array goes from the
    batch into a pinned staging buffer, then to the card without
    blocking, and an event recorded after the copies is waited on by the
    consumer's stream in ``iter_next``, which also marks the arrays as
    used there (``record_stream``). Wrapping a ``DeviceAugmentIter``
    runs its upload and augmentation on that thread too. An array the
    wrapped iterator already placed on the device is not copied. Pad and
    index pass through.
    """

    def __init__(self, base, depth=2, sharding=None, mesh=None,
                 data_axis="dp"):
        super().__init__()
        self._base = base
        self.batch_size = base.batch_size
        device = _prefetch_device(sharding, mesh, data_axis)
        self._device = device
        stream = torch.cuda.Stream(device) if device.type == "cuda" \
            else None
        self._current = None

        def stage(batch, _dev=device, _stream=stream):
            # closes over the device and stream only, NOT self: the
            # pipeline thread holds this transform, and a reference to
            # self would keep the iterator (and its thread) alive forever
            return _stage_batch(batch, _dev, _stream)

        source = base if stream is None else _OnStream(base, stream)
        self._stream = StagedStream(source, place=stage, depth=depth,
                                    thread=True)
        self._worker = self._stream._worker  # the pipeline Thread

    def close(self):
        """Stop the pipeline thread (also run by ``__del__``)."""
        s = getattr(self, "_stream", None)
        if s is not None:
            s.close()

    def __del__(self):
        self.close()

    @property
    def provide_data(self):
        return self._base.provide_data

    @property
    def provide_label(self):
        return self._base.provide_label

    def reset(self):
        self._stream.reset()

    def iter_next(self):
        try:
            batch = self._stream.next()
        except StopIteration:
            batch = None
        if batch is not None and batch._ready is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(batch._ready)
            for a in batch.data + batch.label:
                a._tensor.record_stream(cur)
        self._current = batch
        return batch is not None

    def getdata(self):
        return self._current.data

    def getlabel(self):
        return self._current.label

    def getindex(self):
        return self._current.index

    def getpad(self):
        return self._current.pad


def _read_idx_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise MXNetError("bad MNIST image file %s" % path)
        data = np.frombuffer(f.read(num * rows * cols), dtype=np.uint8)
        return data.reshape(num, rows, cols)


def _read_idx_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise MXNetError("bad MNIST label file %s" % path)
        return np.frombuffer(f.read(num), dtype=np.uint8)


class MNISTIter(NDArrayIter):
    """The idx-ubyte MNIST reader (reference ``src/io/iter_mnist.cc``):
    shuffle, flat or ``(1, 28, 28)``, ``num_parts``/``part_index``
    sharding."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, silent=False, seed=0, input_shape=None,
                 num_parts=1, part_index=0, **kwargs):
        images = _read_idx_images(image).astype(np.float32) / 255.0
        labels = _read_idx_labels(label).astype(np.float32)
        if flat:
            images = images.reshape(len(images), -1)
        else:
            images = images.reshape(len(images), 1,
                                    images.shape[1], images.shape[2])
        if input_shape is not None:
            images = images.reshape((len(images),) + tuple(input_shape))
        if shuffle:
            rs = np.random.RandomState(seed)
            idx = rs.permutation(len(images))
            images, labels = images[idx], labels[idx]
        if num_parts > 1:
            images = images[part_index::num_parts]
            labels = labels[part_index::num_parts]
        super().__init__(images, labels, batch_size=batch_size,
                         shuffle=False, last_batch_handle="discard")


class CSVIter(NDArrayIter):
    """The CSV reader (reference ``src/io/iter_csv.cc``): ``data_csv`` and
    ``label_csv`` with declared shapes."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=128, round_batch=True,
                 **kwargs):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros(data.shape[0], dtype=np.float32)
        super().__init__(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard")


def _imagerecorditer(*args, **kwargs):
    """``mx.io.ImageRecordIter`` (``image_io.ImageRecordIter``)."""
    from .image_io import ImageRecordIter as _IRI
    return _IRI(*args, **kwargs)


ImageRecordIter = _imagerecorditer


class MXDataIter(DataIter):
    """Wrap a DataIterHandle from the native C graph ABI (reference
    io.py:426: MXDataIter wraps C-registered iterators).

    ``handle`` is the opaque id returned by ``MXTDataIterCreateIter`` /
    ``c_api_impl.data_iter_create``, so iterators created through the C
    ABI and Python code can share state. Prefer the direct classes
    (MNISTIter/CSVIter/ImageRecordIter) in pure-Python programs.
    """

    def __init__(self, handle, data_name="data",
                 label_name="softmax_label"):
        from . import c_api_impl as _impl
        self._impl = _impl
        self.handle = int(handle)
        super().__init__()
        inner = _impl._get(self.handle)
        self.batch_size = getattr(inner, "batch_size", 0)
        self.data_name = data_name
        self.label_name = label_name

    def reset(self):
        self._impl.data_iter_before_first(self.handle)

    def iter_next(self):
        return bool(self._impl.data_iter_next(self.handle))

    def getdata(self):
        hid = self._impl.data_iter_get_data(self.handle)
        try:
            return [self._impl._get(hid)]  # list, like NDArrayIter
        finally:
            self._impl.free_handle(hid)

    def getlabel(self):
        hid = self._impl.data_iter_get_label(self.handle)
        try:
            return [self._impl._get(hid)]
        finally:
            self._impl.free_handle(hid)

    def getindex(self):
        idx = self._impl.data_iter_get_index(self.handle)
        return np.asarray(idx) if idx else None

    def getpad(self):
        return self._impl.data_iter_get_pad(self.handle)

    @property
    def provide_data(self):
        return getattr(self._impl._get(self.handle), "provide_data", None)

    @property
    def provide_label(self):
        return getattr(self._impl._get(self.handle), "provide_label", None)

    def __del__(self):
        try:
            self._impl.free_handle(self.handle)
        except Exception:  # interpreter shutdown
            pass
