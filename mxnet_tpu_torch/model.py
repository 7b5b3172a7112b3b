"""Checkpoints: ``prefix-symbol.json``, ``prefix-NNNN.params`` and
``prefix-NNNN.states``; the ``BatchEndParam`` callback protocol.

Counterpart of the checkpoint half of ``mxnet_tpu/model.py`` (l.538-766,
the reference's ``model.py:311``/``:338``): the same file names and
``arg:``/``aux:`` key prefixes, and the optimizer-state blob pickled
beside the parameters with numpy leaves, so a checkpoint written by
either package loads in the other. The publication rules are the JAX
package's: every file goes through ``tmp`` + ``os.replace`` (a stale
``.tmp`` from a writer that died is removed first), ``.states`` is
published before ``.params`` (the completeness marker
``latest_checkpoint`` keys off), and a save without optimizer state
removes a stale ``.states`` that an earlier run left at that epoch.
``params_from_numpy`` carries parameters across from the JAX package (as
numpy arrays) and places them on a device.
"""
from __future__ import annotations

import glob
import logging
import os
import pickle
import re
import threading
import time
from collections import namedtuple

import numpy as np
import torch

from . import ndarray as nd
from . import symbol as sym
from . import telemetry as tele
from .base import MXNetError, later_slice, torch_dtype
from .context import resolve_device

__all__ = ["save_checkpoint", "load_checkpoint", "load_optimizer_states",
           "latest_checkpoint", "params_from_numpy", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])

_TM_CKPT_MS = tele.histogram("checkpoint.write_ms")


def _run_callbacks(callbacks, params):
    for cb in (callbacks if isinstance(callbacks, list) else [callbacks]):
        cb(params)


def _strip_file_uri(path):
    return path[len("file://"):] if path.startswith("file://") else path


def _local(path, what):
    """A local path for ``path``; remote URIs raise (the port has no
    stream layer for them yet)."""
    path = _strip_file_uri(path)
    if path.startswith(("s3://", "hdfs://")):
        raise later_slice(what, "remote URIs (%s)" % path.split("://")[0])
    return path


def _clear_stale_tmp(tmp_name):
    """Remove a tmp file a writer left when it died before its
    ``os.replace``: a later save's in-flight write to the same path would
    be indistinguishable from it."""
    if os.path.exists(tmp_name):
        logging.warning("removing stale checkpoint temp file %s (a "
                        "previous writer died mid-save)", tmp_name)
        try:
            os.remove(tmp_name)
        except OSError:
            pass


def _publish(path, writer):
    """tmp + os.replace publication of one local checkpoint file."""
    tmp_name = path + ".tmp"
    _clear_stale_tmp(tmp_name)
    writer(tmp_name)
    os.replace(tmp_name, path)


# per-prefix locks serializing in-process checkpoint writers (an async
# do_checkpoint callback and a synchronous save on the SAME prefix would
# otherwise race on the same .tmp paths); unrelated prefixes stay parallel
_SAVE_LOCKS = {}
_SAVE_LOCKS_GUARD = threading.Lock()
# absolute .states paths this process published: a states-less save of
# the same epoch (a do_checkpoint callback beside a save with states)
# must not remove them; only a stale file from an earlier run is removed
_STATES_PUBLISHED = set()


def _save_lock_for(prefix):
    key = os.path.abspath(prefix)
    with _SAVE_LOCKS_GUARD:
        return _SAVE_LOCKS.setdefault(key, threading.Lock())


def _host(v):
    """What a ``.params`` file takes: a tensor on the CPU, or numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return np.asarray(v)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    optimizer_states=None):
    """Save ``prefix-symbol.json`` and ``prefix-%04d.params``; with
    ``optimizer_states`` (a picklable blob, e.g. ``updater.get_states()``
    or ``ParallelTrainer.get_optimizer_states()``) also
    ``prefix-%04d.states``, so a resumed run continues the same optimizer
    trajectory. Records the ``checkpoint.save`` span and the
    ``checkpoint.write_ms`` histogram."""
    local = _local(prefix, "save_checkpoint")
    save_dict = {("arg:%s" % k): _host(v) for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): _host(v)
                      for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (local, epoch)
    states_name = param_name[:-len(".params")] + ".states"
    t0 = time.perf_counter()
    with _save_lock_for(local):
        _publish("%s-symbol.json" % local, symbol.save)
        if optimizer_states is None:
            if os.path.abspath(states_name) not in _STATES_PUBLISHED \
                    and os.path.exists(states_name):
                logging.warning("removing stale optimizer-state file %s "
                                "(this checkpoint has no optimizer state)",
                                states_name)
                try:
                    os.remove(states_name)
                except OSError:
                    pass
        else:
            def write_states(path):
                with open(path, "wb") as f:
                    pickle.dump(optimizer_states, f,
                                protocol=pickle.HIGHEST_PROTOCOL)
            _publish(states_name, write_states)
            with _SAVE_LOCKS_GUARD:
                _STATES_PUBLISHED.add(os.path.abspath(states_name))
        _publish(param_name, lambda p: nd.save(p, save_dict))
    dt = time.perf_counter() - t0
    _TM_CKPT_MS.observe(dt * 1e3)
    tele.trace_complete("checkpoint.save", t0, dt, args={"epoch": epoch})
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """Load (symbol, arg_params, aux_params); arrays are CPU tensors."""
    local = _local(prefix, "load_checkpoint")
    symbol = sym.load("%s-symbol.json" % local)
    save_dict = nd.load("%s-%04d.params" % (local, epoch))
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


def load_optimizer_states(prefix, epoch):
    """The optimizer-state blob saved beside ``prefix-%04d.params``, or
    None when that epoch was saved without one. Unpickles the file, so
    load only checkpoints this program (or the JAX package) wrote."""
    path = "%s-%04d.states" % (_local(prefix, "load_optimizer_states"),
                               epoch)
    try:
        f = open(path, "rb")
    except OSError:
        return None
    with f:
        return pickle.load(f)


def latest_checkpoint(prefix):
    """The largest epoch N for which ``prefix-%04d.params`` exists (the
    anchored ``%04d`` match: ``cp-b-cp-0007.params`` is not epoch 7 of
    ``cp``), or None; in-flight ``.tmp`` files do not count."""
    prefix = _strip_file_uri(prefix)
    if prefix.startswith(("s3://", "hdfs://")):
        return None  # remote prefixes cannot be listed
    best = None
    pat = re.compile(re.escape(os.path.basename(prefix))
                     + r"-(\d{4,})\.params$")
    for path in glob.glob(glob.escape(prefix) + "-*.params"):
        m = pat.match(os.path.basename(path))
        if m:
            epoch = int(m.group(1))
            best = epoch if best is None else max(best, epoch)
    return best


def params_from_numpy(arg_params, device, dtype=None, symbol=None,
                      input_shapes=None):
    """Place a dict of numpy arrays (e.g. the JAX package's parameters,
    ``{k: np.asarray(v)}``) on ``device`` as torch tensors. The names and
    ``[out, in]`` layouts are the JAX package's own, so nothing is
    transposed. ``dtype`` casts floating arrays (integer ones keep
    theirs). With ``symbol`` (and ``input_shapes`` for its data inputs,
    e.g. ``{"data": (1, T)}``) every shape is checked against the
    symbol's ``infer_shape`` first, and a mismatch raises."""
    if symbol is not None:
        arg_shapes, _, _ = symbol.infer_shape(**dict(input_shapes or {}))
        if arg_shapes is None:
            raise MXNetError("params_from_numpy: the symbol's shapes are "
                             "underdetermined; pass input_shapes for its "
                             "data inputs")
        for name, want in zip(symbol.list_arguments(), arg_shapes):
            if name in arg_params \
                    and tuple(np.shape(arg_params[name])) != tuple(want):
                raise MXNetError(
                    "params_from_numpy: %s has shape %s, the symbol "
                    "wants %s" % (name, np.shape(arg_params[name]),
                                  tuple(want)))
    dev = resolve_device(device)
    cast = None if dtype is None else torch_dtype(dtype)
    out = {}
    for k, v in arg_params.items():
        t = torch.as_tensor(np.ascontiguousarray(v)) \
            if isinstance(v, np.ndarray) else torch.as_tensor(v)
        if cast is not None and t.is_floating_point():
            t = t.to(cast)
        out[k] = t.to(dev)
    return out
