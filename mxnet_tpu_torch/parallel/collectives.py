"""Collectives between the ranks of a single-controller SPMD program.

Counterpart of ``mxnet_tpu/parallel/collectives.py`` (l.29-123). Inside a
JAX ``shard_map`` each collective is an array op over the devices of a
named mesh axis; here one process holds every rank's shard, and each
collective is a function of the LIST of the ranks' shards along one axis
(rank ``i``'s shard at index ``i``) that returns the list of results, each
on its rank's device. The data movement is ``.to(device)``: nothing on one
device, a peer copy between cards. Every function is made of copies,
concatenations and sums, so autograd differentiates through it: the
backward of a rotation is the reverse rotation and that of ``psum`` a
``psum``, as in JAX, with no hand-written transpose.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError

__all__ = ["psum", "all_gather", "reduce_scatter", "ppermute", "all_to_all",
           "axis_size", "broadcast", "barrier", "ring_exchange",
           "bucketed_psum"]


def axis_size(xs):
    """The number of ranks along the axis (``lax.psum(1, axis)``)."""
    return len(xs)


def _spread(val, xs):
    """``val`` on every rank's device."""
    return [val.to(x.device) for x in xs]


def _gather(xs):
    """Every shard on rank 0's device, in rank order."""
    return [x.to(xs[0].device) for x in xs]


def psum(xs):
    """The sum of the shards, on every rank (summed in rank order)."""
    parts = _gather(xs)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return _spread(total, xs)


def ppermute(xs, perm):
    """``perm``: (source, destination) rank pairs; a rank no pair sends to
    receives zeros (``lax.ppermute``)."""
    out = [None] * len(xs)
    for src, dst in perm:
        if out[dst] is not None:
            raise MXNetError("ppermute: rank %d receives twice" % dst)
        out[dst] = xs[src].to(xs[dst].device)
    return [o if o is not None else torch.zeros_like(x)
            for o, x in zip(out, xs)]


def ring_exchange(xs, shift=1):
    """Rotate the shards ``shift`` hops around the ring: rank ``i``'s
    shard moves to rank ``(i + shift) % n`` (the ring-attention hop)."""
    n = len(xs)
    return ppermute(xs, [(i, (i + shift) % n) for i in range(n)])


def all_gather(xs, *, axis=0, tiled=True):
    """Every rank gets all shards, concatenated along ``axis`` (``tiled``)
    or stacked in a new ``axis``."""
    parts = _gather(xs)
    whole = torch.cat(parts, dim=axis) if tiled else \
        torch.stack(parts, dim=axis)
    return _spread(whole, xs)


def reduce_scatter(xs, *, scatter_dimension=0, tiled=True):
    """The sum of the shards, rank ``i`` keeping the ``i``-th slice of
    ``scatter_dimension`` (``lax.psum_scatter``): a block of
    ``size / n`` rows when ``tiled``, else the single row ``i`` (the
    dimension must have size n and is dropped)."""
    n = len(xs)
    total = psum(xs)
    size = xs[0].shape[scatter_dimension]
    if tiled:
        if size % n:
            raise MXNetError("reduce_scatter: dimension %d of size %d does "
                             "not split over %d ranks"
                             % (scatter_dimension, size, n))
        return [t.narrow(scatter_dimension, i * (size // n), size // n)
                for i, t in enumerate(total)]
    if size != n:
        raise MXNetError("reduce_scatter: untiled needs dimension %d of "
                         "size %d, got %d" % (scatter_dimension, n, size))
    return [t.select(scatter_dimension, i) for i, t in enumerate(total)]


def all_to_all(xs, split_axis, concat_axis, *, tiled=False):
    """Rank ``j`` receives the ``j``-th piece of ``split_axis`` from every
    rank ``i`` and puts them in rank order along ``concat_axis``
    (``lax.all_to_all``). Untiled, ``split_axis`` has size n and each
    piece is one slice: rank ``j``'s result is
    ``stack([xs[i].select(split_axis, j) for i], concat_axis)``. Tiled,
    the pieces are blocks of ``size / n`` and are concatenated."""
    n = len(xs)
    size = xs[0].shape[split_axis]
    if tiled:
        if size % n:
            raise MXNetError("all_to_all: dimension %d of size %d does not "
                             "split over %d ranks" % (split_axis, size, n))
        pieces = [x.chunk(n, dim=split_axis) for x in xs]
    else:
        if size != n:
            raise MXNetError("all_to_all: untiled needs dimension %d of "
                             "size %d, got %d" % (split_axis, n, size))
        pieces = [x.unbind(dim=split_axis) for x in xs]
    out = []
    for j, dst in enumerate(xs):
        got = [pieces[i][j].to(dst.device) for i in range(n)]
        out.append(torch.cat(got, dim=concat_axis) if tiled else
                   torch.stack(got, dim=concat_axis))
    return out


def broadcast(xs, root=0):
    """Rank ``root``'s shard on every rank (the kvstore Pull's fan-out)."""
    return _spread(xs[root], xs)


def barrier(xs):
    """A zero that depends on every rank's shard, on every rank: thread it
    into later work to order it after all of them (in-program ordering is
    data dependence, as in the JAX package)."""
    return psum([x.sum() * 0.0 for x in xs])


def bucketed_psum(grads, bucket_bytes=4 * 1024 * 1024):
    """``psum`` of many gradients in few fused sums. ``grads``: one dict
    (or list) of tensors per rank, with the same keys and shapes on every
    rank; returns the same structure per rank. Buckets hold one dtype and
    at most ``bucket_bytes`` (a larger tensor gets a bucket of its own),
    so the values equal per-tensor ``psum``'s."""
    is_dict = isinstance(grads[0], dict)
    keys = list(grads[0].keys()) if is_dict else list(range(len(grads[0])))
    buckets, cur, cur_bytes, cur_dt = [], [], 0, None
    for key in keys:
        g = grads[0][key]
        nb = math.prod(g.shape) * g.element_size()
        if cur and (cur_bytes + nb > bucket_bytes or g.dtype != cur_dt):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(key)
        cur_bytes += nb
        cur_dt = g.dtype
    if cur:
        buckets.append(cur)
    out = [dict() for _ in grads]
    for bucket in buckets:
        fused = psum([torch.cat([r[k].reshape(-1) for k in bucket])
                      for r in grads])
        for rank, flat in enumerate(fused):
            parts = flat.split([grads[rank][k].numel() for k in bucket])
            for k, p in zip(bucket, parts):
                out[rank][k] = p.view(grads[rank][k].shape)
    if is_dict:
        return out
    return [[o[k] for k in keys] for o in out]
