"""Data-parallel executor management.

Counterpart of ``mxnet_tpu/executor_manager.py`` (l.29-238; the
reference's ``python/mxnet/executor_manager.py``): ``_split_input_slice``
(work-load slicing with the JAX package's rounding), the argument-name
checks, ``DataParallelExecutorGroup`` (one Executor per context over its
slice of the batch) and ``DataParallelExecutorManager`` with ``sym_gen``
bucketing (the groups share their parameter arrays). The slices run one
after the other from this process; contexts may repeat a device.
"""
from __future__ import annotations

import logging

import numpy as np

from .base import MXNetError
from . import ndarray as nd
from .context import cpu

__all__ = ["DataParallelExecutorManager", "DataParallelExecutorGroup",
           "_split_input_slice", "_check_arguments", "_load_data",
           "_load_label"]


def _split_input_slice(batch_size, work_load_list):
    """Split batch into per-device slices proportional to work load
    (reference executor_manager.py:11-43 semantics): per-device counts
    are the rounded proportional shares, any rounding shortfall lands on
    the last device, and boundaries are clamped to the batch."""
    total = sum(work_load_list)
    counts = [round(w * batch_size / total) for w in work_load_list]
    if sum(counts) < batch_size:
        counts[-1] += batch_size - sum(counts)
    bounds = [0]
    for c in counts:
        bounds.append(int(min(bounds[-1] + c, batch_size)))
    if any(lo >= hi for lo, hi in zip(bounds, bounds[1:])):
        raise ValueError("Too many slices such that some splits are empty")
    return [slice(lo, hi) for lo, hi in zip(bounds, bounds[1:])]


def _check_arguments(symbol):
    """Reject duplicated argument/aux names (reference :46-73)."""
    arg_set = set()
    for name in symbol.list_arguments():
        if name in arg_set:
            raise ValueError("Find duplicated argument name \"%s\"" % name)
        arg_set.add(name)
    aux_set = set()
    for name in symbol.list_auxiliary_states():
        if name in aux_set:
            raise ValueError("Find duplicated auxiliary param name \"%s\""
                             % name)
        aux_set.add(name)


def _load_general(data, targets):
    """Load a batch's arrays into per-device target slices (:76-86)."""
    for d_src, d_targets in zip(data, targets):
        for slice_idx, d_dst in d_targets:
            if d_src.shape == d_dst.shape:
                d_src.copyto(d_dst)
            else:
                d_src[slice_idx].copyto(d_dst)


def _load_data(batch, targets):
    _load_general(batch.data, targets)


def _load_label(batch, targets):
    _load_general(batch.label, targets)


class DataParallelExecutorGroup:
    """One executor per device over sliced batches (reference :146-228)."""

    def __init__(self, sym, arg_names, param_names, ctx, slices, train_data,
                 shared_group=None):
        _check_arguments(sym)
        self.arg_names = arg_names
        self.param_names = param_names
        data_shapes = dict(train_data.provide_data + train_data.provide_label)

        self.train_execs = []
        for i, ctxi in enumerate(ctx):
            shapes = {}
            for k, v in data_shapes.items():
                shapes[k] = (slices[i].stop - slices[i].start,) + tuple(v[1:])
            arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
            if arg_shapes is None:
                raise MXNetError("cannot infer shapes for executor group")
            grad_req = {name: ("write" if name in param_names else "null")
                        for name in arg_names}
            if shared_group is None:
                exec_args = [nd.zeros(s, ctxi) for s in arg_shapes]
            else:
                base = shared_group.train_execs[i]
                exec_args = []
                for name, s in zip(arg_names, arg_shapes):
                    if name in param_names:
                        exec_args.append(base.arg_dict[name])
                    else:
                        exec_args.append(nd.zeros(s, ctxi))
            grads = {name: nd.zeros(s, ctxi)
                     for name, s in zip(arg_names, arg_shapes)
                     if name in param_names}
            train_exec = sym.bind(ctxi, exec_args, grads, grad_req)
            self.train_execs.append(train_exec)

        self.data_names = [x[0] for x in train_data.provide_data]
        self.label_names = [x[0] for x in train_data.provide_label]
        self.data_arrays = [
            [(slices[i], e.arg_dict[name])
             for i, e in enumerate(self.train_execs)]
            for name in self.data_names]
        self.label_arrays = [
            [(slices[i], e.arg_dict[name])
             for i, e in enumerate(self.train_execs)]
            for name in self.label_names]
        self.param_idx = [i for i, name in enumerate(arg_names)
                          if name in param_names]
        self.param_names = [arg_names[i] for i in self.param_idx]
        self.param_arrays = [[e.arg_arrays[i] for e in self.train_execs]
                             for i in self.param_idx]
        self.grad_arrays = [[e.grad_arrays[i] for e in self.train_execs]
                            for i in self.param_idx]
        self.aux_arrays = [[e.aux_arrays[i] for e in self.train_execs]
                           for i in range(len(sym.list_auxiliary_states()))]
        self.slices = slices

    def load_data_batch(self, data_batch):
        _load_data(data_batch, self.data_arrays)
        _load_label(data_batch, self.label_arrays)

    def forward(self, is_train=False):
        for ex in self.train_execs:
            ex.forward(is_train=is_train)

    def backward(self):
        for ex in self.train_execs:
            ex.backward()

    def update_metric(self, metric, labels):
        for ex, part in zip(self.train_execs, self.slices):
            metric.update([lbl[part] for lbl in labels], ex.outputs)


class DataParallelExecutorManager:
    """Manage executor groups incl. bucketing (reference :230-372)."""

    def __init__(self, symbol, ctx, train_data, arg_names, param_names,
                 aux_names, work_load_list=None, logger=None,
                 sym_gen=None):
        if logger is None:
            logger = logging
        self.arg_names = arg_names
        self.param_names = param_names
        self.aux_names = aux_names
        self.ctx = ctx
        batch_size = train_data.batch_size
        if work_load_list is None:
            work_load_list = [1] * len(ctx)
        assert isinstance(work_load_list, list) and \
            len(work_load_list) == len(ctx)
        self.slices = _split_input_slice(batch_size, work_load_list)
        self.symbol = symbol
        self.sym_gen = sym_gen
        self.curr_execgrp = None
        self.execgrp = DataParallelExecutorGroup(
            symbol, arg_names, param_names, ctx, self.slices, train_data)
        if self.sym_gen is not None:
            self.execgrp_bucket = {train_data.default_bucket_key: self.execgrp}

    def install_monitor(self, monitor):
        if self.sym_gen is not None:
            raise NotImplementedError(
                "Monitoring is not implemented for bucketing")
        for train_exec in self.execgrp.train_execs:
            monitor.install(train_exec)

    def set_params(self, arg_params, aux_params):
        for ex in self.execgrp.train_execs:
            ex.copy_params_from(arg_params, aux_params)

    @staticmethod
    def _mean_out(names, blocks, dst):
        """Device-mean each replicated block into ``dst`` on host."""
        for name, replicas in zip(names, blocks):
            mean = sum(r.copyto(cpu()) for r in replicas) / len(replicas)
            mean.copyto(dst[name])

    def copy_to(self, arg_params, aux_params):
        """Copy (averaged over devices) params out (reference :300-310)."""
        self._mean_out(self.param_names, self.param_arrays, arg_params)
        self._mean_out(self.aux_names, self.aux_arrays, aux_params)

    @property
    def param_arrays(self):
        return self.curr_execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.curr_execgrp.grad_arrays

    @property
    def aux_arrays(self):
        return self.curr_execgrp.aux_arrays

    def _group_for(self, batch):
        """The executor group serving this batch: the sole group when
        not bucketing, else the bucket's group (built on first sight,
        sharing params with the default group)."""
        if self.sym_gen is None:
            return self.execgrp
        key = batch.bucket_key
        if key not in self.execgrp_bucket:
            self.execgrp_bucket[key] = DataParallelExecutorGroup(
                self.sym_gen(key), self.arg_names, self.param_names,
                self.ctx, self.slices, batch, shared_group=self.execgrp)
        return self.execgrp_bucket[key]

    def load_data_batch(self, data_batch):
        self.curr_execgrp = self._group_for(data_batch)
        self.curr_execgrp.load_data_batch(data_batch)

    def forward(self, is_train=False):
        self.curr_execgrp.forward(is_train=is_train)

    def backward(self):
        self.curr_execgrp.backward()

    def update_metric(self, metric, labels):
        self.curr_execgrp.update_metric(metric, labels)
