"""Sharded checkpoints of the trainers' state.

Counterpart of ``mxnet_tpu/parallel/checkpoint.py``, with its files:

    prefix-manifest.json          the step, the process count, each
                                  array's global shape, dtype and spec
    prefix-shards-p{R}.npz        process R's shards, keyed
                                  ``name|start:stop,...`` by the slice of
                                  the global array each holds

and its names: the parameters by name, the optimizer state's leaves as
``opt/<param>/<i>`` (the JAX package's tree order) and the aux states as
``aux/<name>``. A checkpoint written by either package loads in the
other. Every process writes its own file: an array held whole as one
shard covering it, with a replicated spec (which the JAX package's
``load_sharded`` places on any mesh); a parameter that a
``ParallelTrainer`` on a mesh stores sharded as each distinct shard once
(the replica of its lowest rank, written by the process that owns that
rank), keyed by its slice, with its spec, as a JAX process writes the
replica-0 shards of its devices. Loading assembles each global array from
whatever shards the files hold, the JAX package's per-device slices
included, in any process count.

Every file lands through ``tmp`` + ``os.replace``, and the manifest,
written last by process 0 (``"nprocs"``: the process count), is the
completeness marker: :func:`latest_step` returns a step only when the
manifest and every shard file it names exist. Across processes a
synchronous save orders the manifest after every shard file with gloo
barriers on the calling thread; the ``async_write=True`` writer thread
issues no collective (it would race the training step's) and follows
the JAX package's marker-file protocol instead (``mxnet_tpu/parallel/
checkpoint.py`` l.79-160): each process drops a marker named by a token
that rank 0 broadcast on the calling thread, rank 0 publishes the
manifest once every marker is there, and the others wait for that
manifest.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time

import numpy as np
import torch

from ..base import MXNetError
from .. import distributed

__all__ = ["save_sharded", "load_sharded", "latest_step",
           "flatten_train_state", "restore_opt_state", "Shards"]

#: an array held as shards: ``pieces`` is ``[(slices, shard), ...]``,
#: ``slices`` a ``(start, stop)`` per dimension (this process's pieces;
#: every process's together cover the array once); ``spec`` the
#: PartitionSpec the manifest records; ``shape`` the global shape
#: (default: where the pieces end); ``dtype`` (a torch dtype, with
#: ``shape``) lets a process that holds none of the array record it in
#: the manifest, which process 0 writes
Shards = collections.namedtuple("Shards",
                                ["spec", "pieces", "shape", "dtype"],
                                defaults=(None, None))

# how long a process waits for its peers' files (seconds)
WAIT_S = 600


def _index_key(shape):
    """The key of a shard covering the whole of an array of ``shape``."""
    return ",".join("0:%d" % d for d in shape)


def _host(arr):
    return arr.detach().to("cpu", copy=True).numpy() \
        if isinstance(arr, torch.Tensor) else np.array(arr)


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _snapshot(params, step, extra):
    """Host copies of ``params`` (later steps update the device values in
    place, so this part cannot wait) and the manifest."""
    blobs = {}
    manifest = {"step": int(step), "nprocs": distributed.process_count(),
                "params": {}, "extra": extra or {}}
    for name, arr in params.items():
        spec = []
        if isinstance(arr, Shards):
            spec = _spec_json(arr.spec)
            shards = [(sl, _host(v)) for sl, v in arr.pieces]
            for sl, host in shards:
                blobs["%s|%s" % (name, ",".join(
                    "%d:%d" % se for se in sl))] = host
            if not shards and (arr.shape is None or arr.dtype is None):
                # none of it here: another process writes it and the
                # manifest
                continue
            gshape = list(arr.shape) if arr.shape is not None else \
                [stop for _, stop in shards[0][0]]
            for sl, _ in shards:
                gshape = [max(g, stop) for g, (_, stop) in zip(gshape, sl)]
            dtype = shards[0][1].dtype if shards else \
                torch.empty(0, dtype=arr.dtype).numpy().dtype
        else:
            host = _host(arr)
            gshape, dtype = list(host.shape), host.dtype
            blobs["%s|%s" % (name, _index_key(host.shape))] = host
        manifest["params"][name] = {
            "global_shape": gshape, "dtype": str(dtype), "spec": spec}
    return blobs, manifest


def _wait(what, ready):
    deadline = time.time() + WAIT_S
    while not ready():
        if time.time() > deadline:
            raise MXNetError("save_sharded: timed out waiting for %s" % what)
        time.sleep(0.05)


def _write(prefix, blobs, manifest, use_collectives=True):
    """This process's shard file, then the manifest (process 0), ordered
    across processes by gloo barriers (``use_collectives``, the calling
    thread) or by marker files (the writer thread)."""
    rank, nprocs = distributed.process_index(), manifest["nprocs"]
    tmp = "%s-shards-p%d.tmp.npz" % (prefix, rank)  # np.savez wants .npz
    np.savez(tmp, **blobs)
    os.replace(tmp, "%s-shards-p%d.npz" % (prefix, rank))
    token = manifest.get("save_token", manifest["step"])

    def marker(r):
        return "%s-done-p%d-%s" % (prefix, r, token)

    if nprocs > 1:
        if use_collectives:
            # every shard file exists before the manifest appears
            distributed.barrier("save_sharded:" + prefix)
        else:
            with open(marker(rank), "w"):
                pass
            if rank == 0:
                _wait("the shard files of %s (save %s)" % (prefix, token),
                      lambda: all(os.path.exists(marker(r))
                                  for r in range(nprocs)))
    if rank == 0:
        mtmp = "%s-manifest.json.tmp" % prefix
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, "%s-manifest.json" % prefix)
    if nprocs > 1:
        if use_collectives:
            # and no process returns (and restores) before it is there
            distributed.barrier("save_sharded_done:" + prefix)
        elif rank == 0:
            for r in range(nprocs):
                try:
                    os.remove(marker(r))
                except OSError:
                    pass
        else:
            def current():
                try:
                    with open("%s-manifest.json" % prefix) as f:
                        m = json.load(f)
                except (OSError, ValueError):
                    return False
                return m.get("save_token", m.get("step")) == token
            _wait("the manifest of %s (save %s)" % (prefix, token),
                  current)


def save_sharded(prefix, params, step=0, extra=None, async_write=False):
    """Write every array of ``params`` (a flat name -> value dict: a
    tensor or array, held whole, or :class:`Shards`: this process's
    pieces). Call from every process, all synchronous or all
    ``async_write=True``, which takes the host snapshot now and writes
    the files on a background thread. Returns ``finalize``, a 0-arg
    callable that joins the writer and raises its error (a no-op when
    synchronous); call it before restoring or exiting. Across processes
    an asynchronous save needs one filesystem at ``prefix`` for every
    process (the marker files)."""
    blobs, manifest = _snapshot(params, step, extra)
    if not async_write:
        _write(prefix, blobs, manifest)
        return lambda: None
    # the save's token, agreed on the calling thread (the one place a
    # collective may run); from os.urandom, so no user stream draws
    tok = torch.tensor([int.from_bytes(os.urandom(4), "little")
                        & 0x7fffffff], dtype=torch.int64)
    if manifest["nprocs"] > 1:
        import torch.distributed as dist
        dist.broadcast(tok, 0)
    manifest["save_token"] = "%d-%08x" % (step, int(tok[0]) & 0xffffffff)
    err = []

    def run():
        try:
            _write(prefix, blobs, manifest, use_collectives=False)
        except BaseException as e:  # raised at finalize()
            err.append(e)

    t = threading.Thread(target=run, daemon=True,
                         name="sharded-ckpt-writer")
    t.start()

    def finalize():
        t.join()
        if err:
            raise err[0]
    return finalize


def latest_step(prefix):
    """The step of the checkpoint at ``prefix`` if it is complete (a
    readable manifest and every shard file it names), else None."""
    try:
        with open("%s-manifest.json" % prefix) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    step, nprocs = manifest.get("step"), manifest.get("nprocs")
    if step is None or nprocs is None:
        return None
    for r in range(nprocs):
        if not os.path.exists("%s-shards-p%d.npz" % (prefix, r)):
            return None
    return step


def _slices(key):
    return tuple(slice(*map(int, part.split(":")))
                 for part in key.split(",")) if key else ()


def load_sharded(prefix, mesh=None, param_specs=None):
    """Reassemble the global arrays from the files of the manifest's
    processes. Returns (params as CPU tensors, step, extra). ``mesh`` and
    ``param_specs`` are the JAX package's placement arguments: the port's
    trainers place the arrays themselves, so they are not read."""
    with open("%s-manifest.json" % prefix) as f:
        manifest = json.load(f)
    out = {}
    filled = {}
    for name, meta in manifest["params"].items():
        out[name] = np.empty(tuple(meta["global_shape"]),
                             dtype=np.dtype(meta["dtype"]))
        filled[name] = np.zeros(out[name].shape, dtype=bool)
    for r in range(manifest["nprocs"]):
        with np.load("%s-shards-p%d.npz" % (prefix, r)) as blobs:
            for key in blobs.files:
                name, idx = key.rsplit("|", 1)
                if name not in out:
                    continue
                sl = _slices(idx)
                out[name][sl] = blobs[key]
                filled[name][sl] = True
    for name, mask in filled.items():
        if not mask.all():
            raise MXNetError("load_sharded: the shards of %r cover %d of "
                             "its %d elements" % (name, int(mask.sum()),
                                                  mask.size))
    return ({n: torch.from_numpy(v) for n, v in out.items()},
            manifest["step"], manifest.get("extra", {}))


def flatten_train_state(params, opt_state, aux_names=(), aux=()):
    """One flat name -> tensor dict of the parameters, the optimizer
    state's leaves (``opt/<param>/<i>``, ``opt_state[param]`` a sequence
    of leaves in the JAX package's order) and the aux states
    (``aux/<name>``)."""
    flat = dict(params)
    for name, leaves in opt_state.items():
        for i, leaf in enumerate(leaves):
            flat["opt/%s/%d" % (name, i)] = leaf
    for name, a in zip(aux_names, aux):
        flat["aux/%s" % name] = a
    return flat


def restore_opt_state(flat, params, opt_init):
    """``{param: [leaf, ...]}`` from a flat dict: each parameter's number
    of leaves is what ``opt_init`` makes for it (run on a shape-only
    tensor, so no trainer state is needed)."""
    out = {}
    for name, param in params.items():
        template = opt_init(torch.empty(tuple(param.shape), device="meta"))
        out[name] = [flat["opt/%s/%d" % (name, i)]
                     for i in range(len(template))]
    return out
