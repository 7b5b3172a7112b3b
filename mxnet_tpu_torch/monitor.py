"""Debugging monitor.

Counterpart of ``mxnet_tpu/monitor.py`` (l.28-101; the reference's
``python/mxnet/monitor.py``): installed on executors, it collects a
statistic of every node output every ``interval`` batches, through
``Executor.set_monitor_callback``. On a monitored batch the executor runs
one extra, unfused walk of the graph (``executor.py``), so a Monitor left
installed roughly doubles the cost of those batches.
"""
from __future__ import annotations

import logging
import re

from . import ndarray as nd
from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    """Collect per-node output stats during training."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                return nd.norm(x) / (x.size ** 0.5)
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def stat_helper(self, name, arr):
        if not self.activated or not self.re_prog.match(name):
            return
        self.queue.append((self.step, name, self.stat_func(arr)))

    def install(self, exe):
        """Install on an executor (reference monitor.py install:53); only
        batches inside a tic()/toc() window pay for the extra walk."""
        exe.set_monitor_callback(self.stat_helper,
                                 should_run=lambda: self.activated)
        self.exes.append(exe)

    def _sync_args(self):
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()

    def tic(self):
        """Arm collection for this batch when the interval elapses
        (reference monitor.py tic:65)."""
        if self.step % self.interval == 0:
            self._sync_args()
            self.queue = []
            self.activated = True
        self.step += 1

    @staticmethod
    def _render(stat):
        values = stat if isinstance(stat, list) else [stat]
        assert all(isinstance(v, NDArray) for v in values)
        return ",".join("%f" % v.asnumpy().ravel()[0] for v in values)

    def toc(self):
        """Disarm and drain: the queued per-node stats plus a sample of
        every argument array (reference monitor.py toc:77-112)."""
        if not self.activated:
            return []
        self._sync_args()
        for exe in self.exes:
            for name, array in zip(exe._arg_names, exe.arg_arrays):
                self.stat_helper(name, array)
        self.activated = False
        entries = sorted(self.queue, key=lambda e: e[1]) if self.sort \
            else self.queue
        self.queue = []
        return [(step, name, self._render(stat))
                for step, name, stat in entries]

    def toc_print(self):
        """Print stats (reference toc_print)."""
        res = self.toc()
        for n, k, v in res:
            logging.info("Batch: %7d %30s %s", n, k, v)
