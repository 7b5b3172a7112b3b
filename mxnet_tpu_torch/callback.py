"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py`` (the reference's
``python/mxnet/callback.py``): ``do_checkpoint`` (an epoch-end callback,
synchronous or with the file write on a thread), ``log_train_metric``,
``Speedometer`` (samples/s, also the ``train.samples_per_sec`` gauge) and
``ProgressBar``.
"""
from __future__ import annotations

import logging
import math
import threading
import time

import numpy as np
import torch

from . import telemetry as _telemetry
from .ndarray import NDArray, _tensor_of

__all__ = ["do_checkpoint", "log_train_metric", "Speedometer", "ProgressBar"]

_TM_SAMPLES_PER_SEC = _telemetry.gauge("train.samples_per_sec")


def _snapshot(v):
    """A host copy that later training steps leave alone."""
    if isinstance(v, (NDArray, torch.Tensor)):
        return _tensor_of(v).detach().to("cpu", copy=True)
    return np.array(v)


def do_checkpoint(prefix, async_write=False):
    """Epoch-end callback ``(iter_no, sym, arg, aux)`` saving
    ``prefix-%04d.params`` for epoch ``iter_no + 1``.

    ``async_write=True`` snapshots the parameters to host memory on the
    caller's thread and writes the files on a background thread, so the
    next epoch's compute overlaps the write. The previous write is joined
    before the next starts (at most one writer; files complete in order)
    and its error is raised there; ``callback.finalize()`` joins the last
    one."""
    state = {"thread": None, "error": None}

    def _write(args):
        from .model import save_checkpoint
        try:
            save_checkpoint(prefix, *args)
        except BaseException as e:  # raised at the next join
            state["error"] = e

    def _join():
        if state["thread"] is not None:
            state["thread"].join()
            state["thread"] = None
        if state["error"] is not None:
            err, state["error"] = state["error"], None
            raise err

    def _callback(iter_no, sym, arg, aux):
        if not async_write:
            from .model import save_checkpoint
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
            return
        _join()
        arg_snap = {k: _snapshot(v) for k, v in arg.items()}
        aux_snap = {k: _snapshot(v) for k, v in aux.items()}
        t = threading.Thread(
            target=_write, args=((iter_no + 1, sym, arg_snap, aux_snap),),
            daemon=True)
        t.start()
        state["thread"] = t

    _callback.finalize = _join
    return _callback


def log_train_metric(period):
    """Log the evaluation metric every ``period`` batches."""
    def _callback(param):
        if param.nbatch % period == 0:
            name, value = param.eval_metric.get()
            logging.info("Iter[%d] Batch [%d]\tTrain-%s=%f",
                         param.epoch, param.nbatch, name, value)
    return _callback


class Speedometer:
    """Log the training speed every ``frequent`` batches.

    A batch count lower than the previous call's starts a new epoch: the
    timer re-arms rather than reporting a speed across the boundary. The
    timer is ``time.perf_counter()``; a zero interval skips the report.
    The rate is also the ``train.samples_per_sec`` gauge."""

    def __init__(self, batch_size, frequent=50):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0

    def _rearm(self):
        self.init = True
        self.tic = time.perf_counter()

    def __call__(self, param):
        count = param.nbatch
        if count < self.last_count:
            self.init = False
        self.last_count = count
        if not self.init:
            self._rearm()
            return
        if count % self.frequent:
            return
        elapsed = time.perf_counter() - self.tic
        if elapsed <= 0:
            self._rearm()
            return
        speed = self.frequent * self.batch_size / elapsed
        _TM_SAMPLES_PER_SEC.set(speed)
        if param.eval_metric is None:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)
        else:
            name, value = param.eval_metric.get()
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                         "\tTrain-%s=%f",
                         param.epoch, count, speed, name, value)
        self._rearm()


class ProgressBar:
    """Text progress bar per epoch; ``total=0`` draws a full bar, and an
    overrun count clamps the bar while the percentage keeps counting."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        frac = 1.0 if self.total <= 0 else count / float(self.total)
        filled_len = min(self.bar_len, int(round(self.bar_len * frac)))
        percents = math.ceil(100.0 * frac)
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s\r", prog_bar, percents, "%")
