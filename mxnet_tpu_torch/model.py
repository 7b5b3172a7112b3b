"""FeedForward, its training loops, and checkpoints: ``prefix-symbol.json``,
``prefix-NNNN.params`` and ``prefix-NNNN.states``; the ``BatchEndParam``
callback protocol.

Counterpart of ``mxnet_tpu/model.py`` (the reference's
``python/mxnet/model.py``): ``FeedForward`` (l.767-1194) with ``fit``,
``predict``, ``score``, ``save``/``load``/``create`` and
``as_serving_engine``, and the loop helpers (l.53-536). ``fit`` runs one
of two loops with one protocol (metrics, callbacks, ``epoch_size``, eval
data, crash-resume from ``fit(checkpoint_prefix=)``):

* the legacy loop ``_train_multi_device``: a
  ``DataParallelExecutorManager`` (one ``Executor`` per context over its
  slice of the batch), then the gradients through the ``KVStore`` and the
  optimizer's updater, one parameter at a time;
* the fused loop ``_train_fused``: the port's ``ParallelTrainer`` on a
  ``dp`` mesh over the contexts (``_mesh_for_ctx``: one rank a context,
  so ``[gpu(0), gpu(0)]`` is two ranks on one card), one captured step
  program on the card, taken by default when every context is a card
  (``_fused_fit_eligible``; the JAX rule "every ctx is a TPU" reads
  "every ctx is a GPU").

The FeedForward's own ``arg_params``/``aux_params`` are NDArrays on
``cpu()``, as the JAX package's default context keeps them; the
executors hold their copies on the contexts.

Checkpoints: the JAX package's file names and ``arg:``/``aux:`` key
prefixes, and the optimizer-state blob pickled beside the parameters with
numpy leaves, so a checkpoint written by either package loads in the
other; ``load_checkpoint`` returns NDArrays on ``cpu()``. The
publication rules are the JAX package's: every file goes through ``tmp``
+ ``os.replace`` (a stale ``.tmp`` from a writer that died is removed
first), ``.states`` is published before ``.params`` (the completeness
marker ``latest_checkpoint`` keys off), and a save without optimizer
state removes a stale ``.states`` that an earlier run left at that epoch.
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
from . import io
from . import kvstore as kvs
from . import metric
from . import optimizer as opt
from .base import MXNetError, torch_dtype
from .context import Context, cpu, current_context, resolve_device
from .executor_manager import (DataParallelExecutorManager,
                               _check_arguments, _load_general)
from .initializer import Uniform
from .stream import open_stream

__all__ = ["FeedForward", "save_checkpoint", "load_checkpoint",
           "load_optimizer_states", "latest_checkpoint", "params_from_numpy",
           "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])

BASE_ESTIMATOR = object

_TM_CKPT_MS = tele.histogram("checkpoint.write_ms")
_TM_DEVICE_MS = tele.histogram("train.device_wait_ms")
# the fused trainer's registry objects: the legacy loop reports under
# the same names, so one snapshot covers whichever loop ran
_TM_TRAIN_STEPS = tele.counter("train.steps")
_TM_TRAIN_STEP_MS = tele.histogram("train.step_ms")


def _run_callbacks(callbacks, params):
    for cb in (callbacks if isinstance(callbacks, list) else [callbacks]):
        cb(params)


def _strip_file_uri(path):
    return path[len("file://"):] if path.startswith("file://") else path


def _is_remote(path):
    return path.startswith(("s3://", "hdfs://"))


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
    """Write one checkpoint file: a remote URI directly (an object store
    publishes on a successful close, ``stream.py``), a local path through
    tmp + os.replace."""
    path = _strip_file_uri(path)
    if _is_remote(path):
        writer(path)
        return
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


def _forget_states_published(prefix):
    """A new fit run starts on ``prefix``: ``.states`` files already on
    disk belong to an earlier run and become eligible for the stale-states
    cleanup again (anchored to the epoch pattern, so ``cp`` does not
    forget ``cp-run2-0003.states``)."""
    base = os.path.abspath(_strip_file_uri(prefix))
    pat = re.compile(re.escape(base) + r"-\d{4,}\.states$")
    with _SAVE_LOCKS_GUARD:
        _STATES_PUBLISHED.difference_update(
            {p for p in _STATES_PUBLISHED if pat.match(p)})


def _save_lock_for(prefix):
    key = _strip_file_uri(prefix)
    if not _is_remote(key):
        key = os.path.abspath(key)
    with _SAVE_LOCKS_GUARD:
        return _SAVE_LOCKS.setdefault(key, threading.Lock())


def _host(v):
    """What a ``.params`` file takes: a tensor on the CPU, or numpy."""
    if isinstance(v, nd.NDArray):
        v = v._tensor
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
    local = _strip_file_uri(prefix)
    save_dict = {("arg:%s" % k): _host(v) for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): _host(v)
                      for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (local, epoch)
    states_name = param_name[:-len(".params")] + ".states"
    t0 = time.perf_counter()
    with _save_lock_for(local):
        _publish("%s-symbol.json" % local, symbol.save)
        if optimizer_states is None:
            if not _is_remote(local) \
                    and os.path.abspath(states_name) \
                    not in _STATES_PUBLISHED \
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
                with open_stream(path, "wb") as f:
                    pickle.dump(optimizer_states, f,
                                protocol=pickle.HIGHEST_PROTOCOL)
            _publish(states_name, write_states)
            if not _is_remote(local):
                with _SAVE_LOCKS_GUARD:
                    _STATES_PUBLISHED.add(os.path.abspath(states_name))
        _publish(param_name, lambda p: nd.save(p, save_dict))
    dt = time.perf_counter() - t0
    _TM_CKPT_MS.observe(dt * 1e3)
    tele.trace_complete("checkpoint.save", t0, dt, args={"epoch": epoch})
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """Load (symbol, arg_params, aux_params); arrays are NDArrays on
    ``cpu()``. ``prefix`` may be a URI (``stream.open_stream``)."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
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
    try:
        # any open failure (a missing local file, an absent remote
        # object) means no state was saved
        f = open_stream("%s-%04d.states" % (prefix, epoch), "rb")
    except Exception:
        return None
    with f:
        return pickle.load(f)


def latest_checkpoint(prefix):
    """The largest epoch N for which ``prefix-%04d.params`` exists (the
    anchored ``%04d`` match: ``cp-b-cp-0007.params`` is not epoch 7 of
    ``cp``), or None; in-flight ``.tmp`` files do not count."""
    prefix = _strip_file_uri(prefix)
    if _is_remote(prefix):
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


# -- the loops ------------------------------------------------------------------

def _create_kvstore(kvstore, num_device, arg_params):
    """KVStore selection (reference model.py:36-76): one device -> no
    kvstore; "local" picks update-on-kvstore or allreduce by the largest
    parameter (16 M elements)."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            if kvstore == "local":
                max_size = max(np.prod(param.shape)
                               for param in arg_params.values())
                if max_size < 1024 * 1024 * 16:
                    kvstore = "local_update_cpu"
                else:
                    kvstore = "local_allreduce_cpu"
                logging.info("Auto-select kvstore type = %s", kvstore)
            kv = kvs.create(kvstore)
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    else:
        update_on_kvstore = "allreduce" not in kv.type
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Init the kvstore's keys and broadcast the initial weights
    (reference :78-97)."""
    keys = list(range(len(param_arrays)))
    kvstore.init(keys, [arg_params[param_names[i]] for i in keys])
    if update_on_kvstore:
        for idx, param_on_devs in enumerate(param_arrays):
            kvstore.pull(idx, param_on_devs, priority=-idx)


def _updatable(param_arrays, grad_arrays):
    """(key, weights per device, grads per device) of every parameter with
    a gradient."""
    for key, (weights, grads) in enumerate(zip(param_arrays, grad_arrays)):
        if grads[0] is not None:
            yield key, weights, grads


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore):
    """The store sums each key's device gradients, applies its optimizer,
    and the pull fans the new weights out (reference model.py:88-97)."""
    for key, weights, grads in _updatable(param_arrays, grad_arrays):
        kvstore.push(key, grads, priority=-key)
        kvstore.pull(key, weights, priority=-key)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None):
    """Sum the gradients through the kvstore when there is one (the pull
    overwrites each device's gradient with the sum), then run the updater
    once per (key, device) (reference model.py:99-116)."""
    for key, weights, grads in _updatable(param_arrays, grad_arrays):
        if kvstore:
            kvstore.push(key, grads, priority=-key)
            kvstore.pull(key, grads, priority=-key)
        for dev, (w, g) in enumerate(zip(weights, grads)):
            updater(key * num_device + dev, g, w)


def _epoch_batches(train_data, epoch_size, logger, epoch):
    """One epoch's batches: exactly ``epoch_size`` of them (the iterator
    rewound as often as needed) when it is set, else one full pass and a
    rewind at its end."""
    served = 0
    while True:
        ran_dry = True
        for batch in train_data:
            yield batch
            served += 1
            if epoch_size is not None and served >= epoch_size:
                ran_dry = False
                break
        if ran_dry:
            logger.info("Epoch[%d] Resetting Data Iterator", epoch)
            train_data.reset()
        if epoch_size is None or served >= epoch_size:
            return


def _train_epochs(begin_epoch, end_epoch, batches, step, eval_metric,
                  logger, batch_end_callback=None, epoch_end=None,
                  eval_data=None, evaluate=None, eval_batch_end_callback=None,
                  first_nbatch=1):
    """The epoch protocol of every training loop (the legacy and the fused
    ``fit``, ``ParallelTrainer.fit``). For each epoch: the metric reset,
    every batch of ``batches(epoch)`` (called at the epoch's start) through
    ``step(batch)``, which also updates the metric, then
    ``batch_end_callback`` with ``nbatch`` counted from ``first_nbatch``;
    the ``train.epoch`` span; ``epoch_end(epoch, seconds)`` (logging,
    parameter sync, callbacks, checkpoints); and the eval pass, each batch
    of ``eval_data`` through ``evaluate(batch)``, which updates the
    metric."""
    for epoch in range(begin_epoch, end_epoch):
        tic = time.time()
        ep_t0 = time.perf_counter()
        eval_metric.reset()
        for nbatch, batch in enumerate(batches(epoch), first_nbatch):
            step(batch)
            if batch_end_callback is not None:
                _run_callbacks(batch_end_callback, BatchEndParam(
                    epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                    locals=locals()))
        tele.trace_complete("train.epoch", ep_t0,
                            time.perf_counter() - ep_t0,
                            args={"epoch": epoch})
        if epoch_end is not None:
            epoch_end(epoch, time.time() - tic)
        if eval_data is not None:
            eval_metric.reset()
            eval_data.reset()
            for i, eval_batch in enumerate(eval_data):
                evaluate(eval_batch)
                if eval_batch_end_callback is not None:
                    _run_callbacks(eval_batch_end_callback, BatchEndParam(
                        epoch=epoch, nbatch=i, eval_metric=eval_metric,
                        locals=locals()))
            name, value = eval_metric.get()
            logger.info("Epoch[%d] Validation-%s=%f", epoch, name, value)
            eval_data.reset()


def _epoch_end_callbacks(epoch_end_callback, epoch, symbol, arg_params,
                         aux_params):
    if epoch_end_callback is None:
        return
    for callback in (epoch_end_callback
                     if isinstance(epoch_end_callback, list)
                     else [epoch_end_callback]):
        callback(epoch, symbol, arg_params, aux_params)


def _resume_blob_fits(resume_states, expected_format, live_opt_name,
                      logger):
    """False (with a warning) when a checkpointed optimizer-state blob was
    written by the other loop or under another optimizer: the run then
    goes on from the checkpointed parameters with fresh optimizer
    state."""
    if resume_states.get("format") != expected_format:
        logger.warning(
            "resume: checkpointed optimizer state (format=%r) does not "
            "fit this training path — continuing with checkpointed "
            "params but fresh optimizer state",
            resume_states.get("format"))
        return False
    saved_opt = resume_states.get("optimizer")
    if saved_opt is not None and live_opt_name is not None \
            and saved_opt != live_opt_name:
        logger.warning(
            "resume: checkpoint was saved under optimizer %r but this "
            "run uses %r — continuing with checkpointed params but "
            "fresh optimizer state", saved_opt, live_opt_name)
        return False
    return True


def _restore_updater_states(updater, resume_states, logger):
    """Apply a checkpointed blob to an updater, unless it does not fit."""
    if resume_states is None:
        return
    if updater is None or not hasattr(updater, "set_states"):
        logger.warning(
            "resume: checkpointed optimizer state (format=%r) does not "
            "fit this training path — continuing with checkpointed "
            "params but fresh optimizer state",
            resume_states.get("format"))
        return
    live_opt = getattr(updater, "optimizer", None)
    if not _resume_blob_fits(
            resume_states, "updater",
            type(live_opt).__name__ if live_opt is not None else None,
            logger):
        return
    updater.set_states(resume_states)
    logger.info("resume: restored optimizer state (%d param slots)",
                len(resume_states.get("states", {})))


def _is_checkpoint_writer(kvstore):
    """In multi-process dist training every worker runs the training
    loop, but only rank 0 publishes the shared checkpoint files: the
    save-path serialization (_SAVE_LOCKS) is in-process only and cannot
    arbitrate two ranks writing the same .tmp path on a shared FS."""
    if kvstore is None or "dist" not in getattr(kvstore, "type", ""):
        return True
    return getattr(kvstore, "rank", 0) == 0


def _updater_states_blob(updater):
    """The updater's checkpointable blob, tagged with its loop and
    optimizer."""
    if updater is None or not hasattr(updater, "get_states"):
        return None
    blob = updater.get_states()
    blob["format"] = "updater"
    if getattr(updater, "optimizer", None) is not None:
        blob["optimizer"] = type(updater.optimizer).__name__
    return blob


def _train_multi_device(symbol, ctx, arg_names, param_names, aux_names,
                        arg_params, aux_params, begin_epoch, end_epoch,
                        epoch_size, optimizer, kvstore, update_on_kvstore,
                        train_data, eval_data=None, eval_metric=None,
                        epoch_end_callback=None, batch_end_callback=None,
                        logger=None, work_load_list=None, monitor=None,
                        eval_batch_end_callback=None, sym_gen=None,
                        checkpoint_prefix=None, resume_states=None):
    """The legacy training loop (reference model.py:118-308)."""
    if logger is None:
        logger = logging
    executor_manager = DataParallelExecutorManager(
        symbol=symbol, sym_gen=sym_gen, ctx=ctx, train_data=train_data,
        param_names=param_names, arg_names=arg_names, aux_names=aux_names,
        work_load_list=work_load_list, logger=logger)
    if monitor:
        executor_manager.install_monitor(monitor)
    executor_manager.set_params(arg_params, aux_params)

    if not update_on_kvstore:
        updater = opt.get_updater(optimizer)
        _restore_updater_states(updater, resume_states, logger)
    if kvstore:
        _initialize_kvstore(kvstore=kvstore,
                            param_arrays=executor_manager.execgrp.param_arrays,
                            arg_params=arg_params,
                            param_names=executor_manager.param_names,
                            update_on_kvstore=update_on_kvstore)
    if update_on_kvstore:
        kvstore.set_optimizer(optimizer)
        if resume_states is not None:
            _restore_updater_states(getattr(kvstore, "_updater", None),
                                    resume_states, logger)

    def step(data_batch):
        executor_manager.load_data_batch(data_batch)
        if monitor is not None:
            monitor.tic()
        step_t0 = time.perf_counter()
        executor_manager.forward(is_train=True)
        executor_manager.backward()
        if update_on_kvstore:
            _update_params_on_kvstore(executor_manager.param_arrays,
                                      executor_manager.grad_arrays, kvstore)
        else:
            _update_params(executor_manager.param_arrays,
                           executor_manager.grad_arrays, updater=updater,
                           num_device=len(ctx), kvstore=kvstore)
        # the host's part of a step: forward, backward and update
        # dispatched (the card may still be running them)
        _TM_TRAIN_STEPS.inc()
        _TM_TRAIN_STEP_MS.observe((time.perf_counter() - step_t0) * 1e3)
        if monitor is not None:
            monitor.toc_print()
        executor_manager.update_metric(eval_metric, data_batch.label)

    def epoch_end(epoch, seconds):
        logger.info("Epoch[%d] Time cost=%.3f", epoch, seconds)
        if epoch_end_callback \
                or (checkpoint_prefix and _is_checkpoint_writer(kvstore)) \
                or epoch + 1 == end_epoch:
            # non-writer dist ranks skip the per-epoch host gather: they
            # would only throw it away at the checkpoint gate below
            executor_manager.copy_to(arg_params, aux_params)
        _epoch_end_callbacks(epoch_end_callback, epoch, symbol, arg_params,
                             aux_params)
        if checkpoint_prefix and _is_checkpoint_writer(kvstore):
            # crash-resume checkpoint: params and optimizer state, every
            # epoch, published atomically
            states = _updater_states_blob(
                getattr(kvstore, "_updater", None) if update_on_kvstore
                else updater)
            save_checkpoint(checkpoint_prefix, epoch + 1, symbol,
                            arg_params, aux_params,
                            optimizer_states=states)

    def evaluate(eval_batch):
        executor_manager.load_data_batch(eval_batch)
        executor_manager.forward(is_train=False)
        executor_manager.update_metric(eval_metric, eval_batch.label)

    train_data.reset()
    _train_epochs(begin_epoch, end_epoch,
                  lambda epoch: _epoch_batches(train_data, epoch_size,
                                               logger, epoch),
                  step, eval_metric, logger,
                  batch_end_callback=batch_end_callback, epoch_end=epoch_end,
                  eval_data=eval_data or None, evaluate=evaluate,
                  eval_batch_end_callback=eval_batch_end_callback)
    _drain_async_writers(epoch_end_callback)


def _fused_fit_eligible(ctx, kvstore, monitor, sym_gen, work_load_list,
                        optimizer):
    """Should fit() run the fused ``ParallelTrainer`` step instead of the
    executor loop? By default, yes when every ctx is a GPU that exists
    (the JAX package's rule reads "every ctx a TPU"), no elsewhere.
    ``MXNET_FUSED_FIT=1`` forces it on contexts of any kind; ``=0``
    forces the legacy loop. What only the legacy loop supports (monitors,
    ``sym_gen`` bucketing, uneven work loads, per-index ``lr_scale``,
    optimizers without an adapter) takes it."""
    flag = os.environ.get("MXNET_FUSED_FIT")
    if flag == "0":
        return False
    if monitor is not None or sym_gen is not None:
        return False
    if work_load_list is not None and len(set(work_load_list)) > 1:
        return False
    if kvstore is not None and "dist" in kvstore.type:
        return False
    if getattr(optimizer, "lr_scale", None):
        return False
    try:
        from .parallel.optim import make_functional
        make_functional(optimizer)
    except MXNetError:
        return False
    if flag == "1":
        return True
    if any(c.device_type != "gpu" for c in ctx):
        return False
    return torch.cuda.is_available() \
        and torch.cuda.device_count() > max(c.device_id for c in ctx)


def _mesh_for_ctx(ctx):
    """A ``dp`` mesh with one rank a context, on the device each names
    (``mxnet_tpu/model.py`` l.386-400; a device may repeat: ``[gpu(0),
    gpu(0)]`` is two ranks on one card)."""
    from .parallel import build_mesh
    return build_mesh({"dp": len(ctx)}, [resolve_device(c) for c in ctx])


def _train_fused(symbol, ctx, arg_params, aux_params, begin_epoch,
                 end_epoch, epoch_size, optimizer, train_data,
                 eval_data=None, eval_metric=None, epoch_end_callback=None,
                 batch_end_callback=None, logger=None, kvstore=None,
                 eval_batch_end_callback=None, checkpoint_prefix=None,
                 resume_states=None):
    """The fused loop: ``_train_multi_device``'s protocol (metrics,
    callbacks, ``epoch_size``, eval data, checkpoints), each step the
    port's ``ParallelTrainer`` step program on a ``dp`` mesh over the
    contexts (the gradient sum over them inside the step)."""
    from .parallel import ParallelTrainer
    if logger is None:
        logger = logging
    if kvstore is not None:
        logger.info("fused fit: '%s' kvstore is subsumed by the "
                    "in-program gradient reduction", kvstore.type)
    input_shapes = dict(train_data.provide_data + train_data.provide_label)
    trainer = ParallelTrainer(symbol, input_shapes, optimizer=optimizer,
                              mesh=_mesh_for_ctx(ctx))
    trainer.init_params(arg_params, aux_params)
    if resume_states is not None and _resume_blob_fits(
            resume_states, "fused", type(optimizer).__name__, logger):
        try:
            trainer.set_optimizer_states(resume_states)
            logger.info("resume: restored fused optimizer state at "
                        "step %d", trainer._t)
        except MXNetError as e:
            logger.warning(
                "resume: %s — continuing with checkpointed params "
                "but fresh optimizer state", e)
    data_names = [x[0] for x in train_data.provide_data]
    label_names = [x[0] for x in train_data.provide_label]

    def sync_params():
        ap, xp = trainer.get_params()
        for k, v in ap.items():
            arg_params[k][:] = v
        for k, v in xp.items():
            aux_params[k][:] = v

    def step(batch):
        data_batch, dev_batch = batch
        outs = trainer.step(dev_batch)
        # the host blocks here, reading the step's outputs for the metric
        fw_t0 = time.perf_counter()
        host = [o.cpu() for o in outs]
        _TM_DEVICE_MS.observe((time.perf_counter() - fw_t0) * 1e3)
        eval_metric.update(data_batch.label, host)

    def epoch_end(epoch, seconds):
        logger.info("Epoch[%d] Time cost=%.3f", epoch, seconds)
        if epoch_end_callback or checkpoint_prefix \
                or epoch + 1 == end_epoch:
            sync_params()
        _epoch_end_callbacks(epoch_end_callback, epoch, symbol, arg_params,
                             aux_params)
        if checkpoint_prefix:
            states = trainer.get_optimizer_states()
            states["format"] = "fused"
            states["optimizer"] = type(optimizer).__name__
            save_checkpoint(checkpoint_prefix, epoch + 1, symbol,
                            arg_params, aux_params, optimizer_states=states)

    def evaluate(eval_batch):
        batch = dict(zip(data_names, eval_batch.data))
        batch.update(zip(label_names, eval_batch.label))
        eval_metric.update(eval_batch.label, trainer.forward(batch))

    staged = trainer.staged_batches(train_data, data_names, label_names)
    staged.reset()
    _train_epochs(begin_epoch, end_epoch,
                  lambda epoch: _epoch_batches(staged, epoch_size, logger,
                                               epoch),
                  step, eval_metric, logger,
                  batch_end_callback=batch_end_callback, epoch_end=epoch_end,
                  eval_data=eval_data or None, evaluate=evaluate,
                  eval_batch_end_callback=eval_batch_end_callback)
    _drain_async_writers(epoch_end_callback)
    return trainer


def _drain_async_writers(epoch_end_callback):
    if epoch_end_callback is None:
        return
    for callback in (epoch_end_callback
                     if isinstance(epoch_end_callback, list)
                     else [epoch_end_callback]):
        finalize = getattr(callback, "finalize", None)
        if finalize is not None:
            finalize()


# -- FeedForward -------------------------------------------------------------------

class FeedForward(BASE_ESTIMATOR):
    """Model estimator over a symbol (reference model.py:371-886)."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=Uniform(0.01),
                 numpy_batch_size=128, arg_params=None, aux_params=None,
                 allow_extra_params=False, begin_epoch=0, **kwargs):
        if isinstance(symbol, sym.Symbol):
            self.symbol = symbol
            self.sym_gen = None
        else:
            assert callable(symbol)
            self.symbol = None
            self.sym_gen = symbol
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.argument_checked = False
        if self.sym_gen is None:
            self._check_arguments()
        if ctx is None:
            ctx = [current_context()]
        elif isinstance(ctx, Context):
            ctx = [ctx]
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer
        self.numpy_batch_size = numpy_batch_size
        self.begin_epoch = begin_epoch
        self._pred_exec = None

    def _check_arguments(self):
        if self.argument_checked:
            return
        assert self.symbol is not None
        self.argument_checked = True
        _check_arguments(self.symbol)
        if self.arg_params:
            arg_names = set(self.symbol.list_arguments())
            self.arg_params = {k: v for k, v in self.arg_params.items()
                               if k in arg_names or not self.allow_extra_params}
        if self.aux_params:
            aux_names = set(self.symbol.list_auxiliary_states())
            self.aux_params = {k: v for k, v in self.aux_params.items()
                               if k in aux_names or not self.allow_extra_params}

    @staticmethod
    def _is_data_arg(name):
        return name.endswith("data") or name.endswith("label")

    def _init_params(self, input_shapes, overwrite=False):
        """Infer the shapes, allocate the parameters on ``cpu()`` and
        initialize them (reference :478): given values are copied, the
        rest drawn by the initializer."""
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**input_shapes)
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes from %s" % (input_shapes,))
        arg_names = self.symbol.list_arguments()
        input_names = list(input_shapes.keys())
        param_names = [key for key in arg_names if key not in input_names]
        aux_names = self.symbol.list_auxiliary_states()
        param_name_shapes = [x for x in zip(arg_names, arg_shapes)
                             if x[0] in param_names]
        arg_params = {k: nd.zeros(s, cpu()) for k, s in param_name_shapes}
        aux_params = {k: nd.zeros(s, cpu())
                      for k, s in zip(aux_names, aux_shapes)}
        for k, v in arg_params.items():
            if self.arg_params and k in self.arg_params and not overwrite:
                v[:] = self.arg_params[k]
            else:
                self.initializer(k, v)
        for k, v in aux_params.items():
            if self.aux_params and k in self.aux_params and not overwrite:
                v[:] = self.aux_params[k]
            else:
                self.initializer(k, v)
        self.arg_params = arg_params
        self.aux_params = aux_params
        return arg_names, param_names, aux_names

    def __getstate__(self):
        this = self.__dict__.copy()
        this["_pred_exec"] = None
        return this

    def __setstate__(self, state):
        self.__dict__.update(state)

    def _init_predictor(self, input_shapes):
        if self._pred_exec is not None:
            arg_shapes, _, _ = self.symbol.infer_shape(**dict(input_shapes))
            pred_shapes = [x.shape for x in self._pred_exec.arg_arrays]
            if arg_shapes == pred_shapes:
                return
        pred_exec = self.symbol.simple_bind(self.ctx[0], grad_req="null",
                                            **dict(input_shapes))
        pred_exec.copy_params_from(self.arg_params, self.aux_params)
        self._pred_exec = pred_exec

    def _init_iter(self, X, y, is_train):
        """Wrap in-memory input into an NDArrayIter (reference :530-560)."""
        if isinstance(X, (np.ndarray, nd.NDArray)):
            if y is None:
                if is_train:
                    raise ValueError("y must be specified when X is numpy")
                y = np.zeros(X.shape[0])
            y = np.asarray(y.asnumpy() if isinstance(y, nd.NDArray) else y)
            if y.ndim == 2 and y.shape[1] == 1:
                y = y.flatten()
            batch_size = min(X.shape[0], self.numpy_batch_size)
            return io.NDArrayIter(X, y, batch_size=batch_size,
                                  shuffle=is_train, last_batch_handle="pad"
                                  if not is_train else "roll_over")
        if not isinstance(X, io.DataIter):
            raise TypeError("X must be DataIter, NDArray or numpy.ndarray")
        return X

    def _init_eval_iter(self, eval_data):
        if eval_data is None:
            return None
        if isinstance(eval_data, (tuple, list)) and len(eval_data) == 2:
            return self._init_iter(eval_data[0], eval_data[1], is_train=True)
        return eval_data

    def _forward_batches(self, X, num_batch):
        """Load each batch into the predictor executor, run it forward and
        yield (index, batch, valid rows); stops after ``num_batch``
        batches without fetching the next one."""
        if num_batch is not None and num_batch <= 0:
            return
        feeds = [self._pred_exec.arg_dict[name]
                 for name, _ in X.provide_data]
        for i, batch in enumerate(X):
            _load_general(batch.data, [[(slice(None), a)] for a in feeds])
            self._pred_exec.forward(is_train=False)
            yield i, batch, X.batch_size - (batch.pad or 0)
            if num_batch is not None and i + 1 >= num_batch:
                return

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """Run prediction: numpy output(s), and with ``return_data`` also
        the (unpadded) data and label streams (reference model.py:573)."""
        X = self._init_iter(X, None, is_train=False)
        if reset:
            X.reset()
        self._init_predictor(X.provide_data)

        def _merge(streams):
            merged = [np.concatenate(chunks) for chunks in streams]
            return merged[0] if len(merged) == 1 else merged

        outs = [[] for _ in self._pred_exec.outputs]
        datas = [[] for _ in X.provide_data]
        labels = [[] for _ in (X.provide_label or [])]
        for _, batch, valid in self._forward_batches(X, num_batch):
            for sink, out_nd in zip(outs, self._pred_exec.outputs):
                sink.append(out_nd.asnumpy()[:valid])
            if return_data:
                for sink, x in zip(datas, batch.data):
                    sink.append(x.asnumpy()[:valid])
                for sink, x in zip(labels, batch.label):
                    sink.append(x.asnumpy()[:valid])
        if return_data:
            return _merge(outs), _merge(datas), _merge(labels)
        return _merge(outs)

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """Evaluate on a metric (reference model.py:634)."""
        if not isinstance(eval_metric, metric.EvalMetric):
            eval_metric = metric.create(eval_metric)
        X = self._init_iter(X, None, is_train=False)
        if reset:
            X.reset()
        self._init_predictor(X.provide_data)
        for i, batch, _ in self._forward_batches(X, num_batch):
            eval_metric.update(batch.label, self._pred_exec.outputs)
            if batch_end_callback is not None:
                _run_callbacks(batch_end_callback,
                               BatchEndParam(epoch=0, nbatch=i,
                                             eval_metric=eval_metric,
                                             locals=locals()))
        return eval_metric.get()[1]

    def _resume_from_checkpoint(self, prefix, logger):
        """Auto-resume: load the latest complete checkpoint at ``prefix``
        (parameters, and the optimizer-state blob when one was saved) and
        move ``begin_epoch`` to it. Returns the blob or None."""
        if _is_remote(_strip_file_uri(prefix)):
            logger.warning(
                "fit: auto-resume does not support remote checkpoint "
                "prefixes (%s); training starts at begin_epoch=%d",
                prefix, self.begin_epoch)
            return None
        epoch = latest_checkpoint(prefix)
        if epoch is None or epoch <= self.begin_epoch:
            return None
        logger.info("fit: auto-resuming from \"%s-%04d.params\" "
                    "(begin_epoch %d -> %d)", prefix, epoch,
                    self.begin_epoch, epoch)
        _, arg_params, aux_params = load_checkpoint(prefix, epoch)
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = epoch
        states = load_optimizer_states(prefix, epoch)
        if states is None:
            logger.warning(
                "fit: no optimizer-state blob next to \"%s-%04d.params\""
                " — resuming with checkpointed params but FRESH "
                "optimizer state", prefix, epoch)
        return states

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_batch_end_callback=None, checkpoint_prefix=None,
            resume=True):
        """Train (reference model.py:681-767). ``checkpoint_prefix`` turns
        on crash-resume: every epoch is checkpointed (parameters and
        optimizer state, published atomically) under it, and unless
        ``resume=False`` a fresh call first reloads the latest complete
        ``prefix-%04d.params`` and continues from that epoch."""
        if self.num_epoch is None:
            raise ValueError("num_epoch must be set when calling fit "
                             "(pass num_epoch= to FeedForward)")
        data = self._init_iter(X, y, is_train=True)
        eval_data = self._init_eval_iter(eval_data)

        resume_states = None
        if checkpoint_prefix is not None:
            _forget_states_published(checkpoint_prefix)
            if resume:
                log = logger if logger is not None else logging
                kv_type = kvstore if isinstance(kvstore, str) \
                    else getattr(kvstore, "type", "")
                if "dist" in (kv_type or ""):
                    # each rank decides begin_epoch from the files IT
                    # sees; with per-worker disks the ranks would resume
                    # at different epochs and hang in collectives
                    log.warning(
                        "fit: dist auto-resume assumes every worker "
                        "sees the same checkpoint files (shared "
                        "filesystem) — ranks resuming at different "
                        "epochs will desynchronize the job")
                resume_states = self._resume_from_checkpoint(
                    checkpoint_prefix, log)

        if self.sym_gen:
            self.symbol = self.sym_gen(data.default_bucket_key)
            self._check_arguments()
        self.kwargs["sym"] = self.symbol

        input_shapes = dict(data.provide_data + data.provide_label)
        arg_names, param_names, aux_names = self._init_params(input_shapes)

        if not isinstance(eval_metric, metric.EvalMetric):
            eval_metric = metric.create(eval_metric)

        (kvstore, update_on_kvstore) = _create_kvstore(
            kvstore, len(self.ctx), self.arg_params)

        optimizer = self.optimizer
        if isinstance(optimizer, str):
            batch_size = data.batch_size
            if kvstore and kvstore.type == "dist_sync":
                batch_size *= kvstore.num_workers
            optimizer = opt.create(optimizer,
                                   rescale_grad=(1.0 / batch_size),
                                   **self.kwargs)
        elif not isinstance(optimizer, opt.Optimizer):
            raise TypeError("optimizer must be str or Optimizer")

        try:
            if _fused_fit_eligible(self.ctx, kvstore, monitor, self.sym_gen,
                                   work_load_list, optimizer):
                _train_fused(
                    self.symbol, self.ctx, self.arg_params, self.aux_params,
                    begin_epoch=self.begin_epoch, end_epoch=self.num_epoch,
                    epoch_size=self.epoch_size, optimizer=optimizer,
                    train_data=data, eval_data=eval_data,
                    eval_metric=eval_metric,
                    epoch_end_callback=epoch_end_callback,
                    batch_end_callback=batch_end_callback,
                    kvstore=kvstore, logger=logger,
                    eval_batch_end_callback=eval_batch_end_callback,
                    checkpoint_prefix=checkpoint_prefix,
                    resume_states=resume_states)
            else:
                _train_multi_device(
                    self.symbol, self.ctx, arg_names, param_names, aux_names,
                    self.arg_params, self.aux_params,
                    begin_epoch=self.begin_epoch, end_epoch=self.num_epoch,
                    epoch_size=self.epoch_size, optimizer=optimizer,
                    train_data=data, eval_data=eval_data,
                    eval_metric=eval_metric,
                    epoch_end_callback=epoch_end_callback,
                    batch_end_callback=batch_end_callback,
                    kvstore=kvstore, update_on_kvstore=update_on_kvstore,
                    logger=logger, work_load_list=work_load_list,
                    monitor=monitor,
                    eval_batch_end_callback=eval_batch_end_callback,
                    sym_gen=self.sym_gen,
                    checkpoint_prefix=checkpoint_prefix,
                    resume_states=resume_states)
        finally:
            _drain_async_writers(epoch_end_callback)
        return self

    def save(self, prefix, epoch=None):
        """Checkpoint (reference :769): prefix-symbol.json + .params."""
        if epoch is None:
            epoch = self.num_epoch
        assert epoch is not None
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params)

    def as_serving_engine(self, max_len, slots=8, prefill_buckets=None,
                          max_queue=256, steps_per_round=1,
                          prefix_cache_mb=None, prefill_chunk=None,
                          overload=None, round_timeout_ms=None,
                          spec_k=None, draft=None, draft_decoder=None,
                          attn_impl=None, capture_dir=None, tp=None,
                          weight_dtype=None, **decoder_kwargs):
        """A fitted (or ``FeedForward.load``-ed) model as the port's
        continuous-batching ``InferenceEngine`` on ``ctx[0]`` (unless
        ``device=`` says otherwise): the checkpoint-to-engine path of
        ``InferenceEngine.from_checkpoint`` without the file round trip.
        ``decoder_kwargs`` reach the ``Decoder`` (``compute_dtype``,
        ``cache_dtype``, ...); the rest are the engine's."""
        from .parallel.decode import Decoder
        from .serving import InferenceEngine

        if self.symbol is None or not self.arg_params:
            raise MXNetError(
                "as_serving_engine needs a trained model: fit() it, "
                "pass arg_params, or use FeedForward.load")
        decoder_kwargs.setdefault("cache_block", None)
        decoder_kwargs.setdefault("weight_dtype", weight_dtype)
        decoder_kwargs.setdefault("device", resolve_device(self.ctx[0]))
        dec = Decoder(self.symbol, dict(self.arg_params), max_len,
                      aux_params=dict(self.aux_params or {}),
                      **decoder_kwargs)
        return InferenceEngine(dec, slots=slots,
                               prefill_buckets=prefill_buckets,
                               max_queue=max_queue,
                               steps_per_round=steps_per_round,
                               prefix_cache_mb=prefix_cache_mb,
                               prefill_chunk=prefill_chunk,
                               overload=overload,
                               round_timeout_ms=round_timeout_ms,
                               spec_k=spec_k, draft=draft,
                               draft_decoder=draft_decoder,
                               capture_dir=capture_dir,
                               attn_impl=attn_impl, tp=tp)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """Load from a checkpoint (reference :793)."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=Uniform(0.01), eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_batch_end_callback=None, **kwargs):
        """Create and fit in one call (reference :821-886)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback,
                  kvstore=kvstore, logger=logger,
                  work_load_list=work_load_list,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
