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

Across processes (a mesh whose ranks live in several processes started
by ``tools/launch.py``, ``distributed.initialize``) a :class:`Span`
names the members of a collective (the ranks or the data-parallel walks,
in global order) and the process that owns each, and moves them over
``torch.distributed`` (gloo, which also runs several ranks on one card;
a card tensor is handed to gloo as it is, and gloo stages it through
host memory and orders itself after the producing stream). Its sum adds
the members in global order, so it equals the one-process ``psum`` bit
for bit at any process count: every member's operand is gathered (by
sends and receives between the processes), then added in order on the
caller's device. :func:`psum_ranked` is that sum
as an autograd function (its backward the same ordered sum of the
outputs' gradients), what a training BatchNorm uses over a mesh in one
process or several. :meth:`Span.ppermute` moves one tensor between the
members of each pair it is given (the pipeline's hop of a boundary
between the processes of neighbouring stages): a send and a receive
where the pair's ends lie in two processes. :func:`ring_hop` and
:func:`all_to_all` given a span are the sequence-parallel ring's hop and
its striped deal across processes: one autograd node over every local
member, whose backward is the reverse rotation or the inverse exchange,
so that every process builds the same graph and reaches the exchanges of
its backward in the same order.
Each cross-process call adds to the ``collectives.cross_calls``,
``collectives.cross_bytes`` (bytes this process sends) and
``collectives.cross_ms`` (the host's wall time in the exchange)
telemetry.
"""
from __future__ import annotations

import math
import time

import torch

from ..base import MXNetError
from .. import distributed
from .. import telemetry as tele

__all__ = ["psum", "pmean", "pmax", "all_gather", "reduce_scatter",
           "ppermute", "all_to_all", "axis_index", "axis_size", "broadcast",
           "barrier", "ring_exchange", "ring_hop", "bucketed_psum", "Span",
           "psum_ranked", "process_sum", "process_broadcast"]

_TM_CROSS_MS = tele.histogram("collectives.cross_ms")
_TM_CROSS_BYTES = tele.counter("collectives.cross_bytes")
_TM_CROSS_CALLS = tele.counter("collectives.cross_calls")
# the piece a cross-process send or receive moves at once
CHUNK_BYTES = 32 << 20


def axis_size(xs):
    """The number of ranks along the axis (``lax.psum(1, axis)``)."""
    return len(xs)


def axis_index(xs):
    """Each rank's index along the axis, an int32 0-dim tensor on its
    device (``lax.axis_index``)."""
    return [torch.tensor(i, dtype=torch.int32, device=x.device)
            for i, x in enumerate(xs)]


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


def pmean(xs):
    """The mean of the shards, on every rank: ``psum`` divided by the
    number of ranks (``lax.pmean``)."""
    return [t / len(xs) for t in psum(xs)]


def pmax(xs):
    """The elementwise maximum of the shards, on every rank (taken in
    rank order; ``lax.pmax``)."""
    parts = _gather(xs)
    top = parts[0]
    for p in parts[1:]:
        top = torch.maximum(top, p)
    return _spread(top, xs)


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


def ring_hop(groups, shift=1, span=None):
    """:func:`ring_exchange` of every list of ``groups`` (the ring's K and
    V) at once. ``span`` (a :class:`Span` over the ring's members in ring
    order): each list holds this process's members (``span.local``), and
    member ``i``'s tensors move to member ``(i + shift) % n`` through ONE
    autograd node (:class:`_RingHop`), in one exchange between the
    processes a hop; without a span, the one-process rotation of each
    list. The node makes each rotated tensor's gradient the sum of two
    terms (its own use and the next hop's), whose order cannot change the
    bits, so a ring in one process and across several add alike."""
    if span is None:
        return [ring_exchange(xs, shift) for xs in groups]
    k = len(groups[0])
    out = _RingHop.apply(span, shift, len(groups),
                         *[x for xs in groups for x in xs])
    return [list(out[g * k:(g + 1) * k]) for g in range(len(groups))]


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


def all_to_all(xs, split_axis, concat_axis, *, tiled=False, span=None):
    """Rank ``j`` receives the ``j``-th piece of ``split_axis`` from every
    rank ``i`` and puts them in rank order along ``concat_axis``
    (``lax.all_to_all``). Untiled, ``split_axis`` has size n and each
    piece is one slice: rank ``j``'s result is
    ``stack([xs[i].select(split_axis, j) for i], concat_axis)``. Tiled,
    the pieces are blocks of ``size / n`` and are concatenated. ``span``
    (a :class:`Span` over the ranks): ``xs`` are this process's ranks'
    (``span.local``), every one of one shape, through ONE autograd node
    (:class:`_AllToAll`, whose backward is the inverse exchange), the
    pieces between processes in one exchange."""
    if span is not None:
        return list(_AllToAll.apply(span, split_axis, concat_axis, tiled,
                                    *xs))
    n = len(xs)
    pieces = _pieces(xs, n, split_axis, tiled)
    out = []
    for j, dst in enumerate(xs):
        got = [pieces[i][j].to(dst.device) for i in range(n)]
        out.append(_join(got, concat_axis, tiled))
    return out


def _pieces(xs, n, split_axis, tiled):
    """Each tensor of ``xs`` cut into its n pieces along ``split_axis``."""
    size = xs[0].shape[split_axis]
    if tiled:
        if size % n:
            raise MXNetError("all_to_all: dimension %d of size %d does not "
                             "split over %d ranks" % (split_axis, size, n))
        return [x.chunk(n, dim=split_axis) for x in xs]
    if size != n:
        raise MXNetError("all_to_all: untiled needs dimension %d of "
                         "size %d, got %d" % (split_axis, n, size))
    return [x.unbind(dim=split_axis) for x in xs]


def _join(got, concat_axis, tiled):
    return torch.cat(got, dim=concat_axis) if tiled else \
        torch.stack(got, dim=concat_axis)


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


# -- across processes ---------------------------------------------------------

class _Timed:
    """Counts one cross-process call of ``nbytes`` and its wall time."""

    def __init__(self, nbytes):
        self.nbytes = nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _TM_CROSS_CALLS.inc()
        _TM_CROSS_BYTES.inc(self.nbytes)
        _TM_CROSS_MS.observe((time.perf_counter() - self.t0) * 1e3)


class Span:
    """The members of a collective, in global order, and the process that
    owns each (``owners[i]``): the ranks of a mesh, or its data-parallel
    walks. This process holds the members ``local``; every process holds
    as many. With every member local nothing crosses a process and the
    functions are the one-process ones."""

    def __init__(self, owners):
        self.owners = [int(p) for p in owners]
        self.n = len(self.owners)
        me = distributed.process_index()
        self.local = [i for i, p in enumerate(self.owners) if p == me]
        self.cross = len(self.local) != self.n
        self.nprocs = distributed.process_count() if self.cross else 1
        self.members = [[i for i, p in enumerate(self.owners) if p == q]
                        for q in range(self.nprocs)] if self.cross \
            else [list(range(self.n))]
        if self.cross and len({len(m) for m in self.members}) != 1:
            raise MXNetError(
                "a collective across processes needs the same number of "
                "members in every process; got %s"
                % [len(m) for m in self.members])

    def gather(self, xs):
        """Every member's tensor, in global order, given this process's
        ``xs`` (one a local member, all of one shape and dtype), on the
        device of ``xs[0]`` (:meth:`_exchange`). A card's operands go
        through pinned host buffers this span keeps (copied out after the
        producing stream's work, copied in before the buffers are used
        again)."""
        xs = list(xs)
        if not self.cross:
            return xs
        shape, numel = xs[0].shape, xs[0].numel()
        flat = torch.cat([x.reshape(-1) for x in xs]) if len(xs) > 1 \
            else xs[0].reshape(-1).contiguous()
        me = distributed.process_index()
        peers = [q for q in range(self.nprocs) if q != me]
        if flat.device.type == "cuda":
            send = self._pinned("send", flat.numel(), flat.dtype)
            send.copy_(flat)  # waits for the stream that made flat
            recv = {q: self._pinned(q, flat.numel(), flat.dtype)
                    for q in peers}
        else:
            send = flat
            recv = {q: torch.empty_like(flat) for q in peers}
        with _Timed(send.numel() * send.element_size() * len(peers)):
            self._exchange(send, recv)
        out = [None] * self.n
        for q, mem in enumerate(self.members):
            parts = xs if q == me else \
                recv[q].to(flat.device).split(numel)
            for i, p in zip(mem, parts):
                out[i] = p.view(shape)
        return out

    def _pinned(self, key, numel, dtype):
        """A pinned host buffer of ``numel`` elements of ``dtype``, kept."""
        if not hasattr(self, "_host"):
            self._host = {}
        k = (key, numel, dtype)
        buf = self._host.get(k)
        if buf is None:
            buf = self._host[k] = torch.empty(numel, dtype=dtype,
                                              pin_memory=True)
        return buf

    def _exchange(self, send, recv):
        """``send`` (this process's host buffer) to every other process
        and ``recv[q]`` from process q. A card's pinned buffers go by
        point-to-point sends and receives in chunks of ``CHUNK_BYTES``
        (two processes on one H100 host, ``chip_smoke.py`` phase 7f: the
        LM's 540 MB gradient 2.4-3.8x faster, BatchNorm's small sums 4-5x,
        than gloo's all-gather of the card tensors); host tensors by
        gloo's all-gather (a CPU mesh's small operands: the sends' waits
        slowed the CPU tests' workers beside their compute threads)."""
        import torch.distributed as dist
        if not send.is_pinned():
            bufs = [recv[q] if q in recv else torch.empty_like(send)
                    for q in range(self.nprocs)]
            dist.all_gather(bufs, send)
            return
        _post([post for q, buf in recv.items()
               for post in ((dist.isend, send, q), (dist.irecv, buf, q))])

    def ppermute(self, xs, perm, devices, meta):
        """``lax.ppermute`` over the members: for each ``(src, dst)`` of
        ``perm`` (global member indices), member src's tensor to member
        dst. ``xs[i]``: member i's tensor where this process owns it and
        it sends (else None); ``devices[i]``: member i's device; ``meta``:
        ``(shape, dtype)`` of what a destination receives. A pair whose
        two ends are local moves by ``.to``; the others go in one
        :meth:`swap`, each end packing its pairs with one peer in
        ``perm``'s order. Returns one entry a member: what a local
        destination received, else None."""
        me = distributed.process_index()
        out = [None] * self.n
        sends, recvs, land = {}, {}, {}
        for src, dst in perm:
            s_mine, d_mine = self.owners[src] == me, self.owners[dst] == me
            if s_mine and d_mine:
                out[dst] = xs[src].to(devices[dst])
            elif s_mine:
                sends.setdefault(self.owners[dst], []).append(xs[src])
            elif d_mine:
                q = self.owners[src]
                recvs.setdefault(q, []).append(tuple(meta) + (devices[dst],))
                land.setdefault(q, []).append(dst)
        got = self.swap(sends, recvs)
        for q, dsts in land.items():
            for dst, t in zip(dsts, got[q]):
                out[dst] = t
        return out

    def swap(self, sends, recvs):
        """Point-to-point between this process and its peers, one call:
        ``sends[q]``, the tensors this process sends to process q, in
        order; ``recvs[q]``, ``[(shape, dtype, device), ...]`` of what it
        receives from q, in the order q sends them. Each peer's tensors
        go as ONE flat buffer each way (a card's through pinned host
        buffers this span keeps), every piece posted before any wait.
        Returns ``{q: [tensor, ...]}``, each received tensor on its
        device."""
        import torch.distributed as dist
        if not any(sends.values()) and not any(recvs.values()):
            return {}
        posts, landed, nbytes = [], [], 0
        for q in sorted(set(sends) | set(recvs)):
            if sends.get(q):
                flat = torch.cat([t.reshape(-1) for t in sends[q]]) \
                    if len(sends[q]) > 1 \
                    else sends[q][0].reshape(-1).contiguous()
                if flat.device.type == "cuda":
                    buf = self._pinned(("swap-send", q), flat.numel(),
                                       flat.dtype)
                    buf.copy_(flat)  # waits for the stream that made it
                    flat = buf
                posts.append((dist.isend, flat, q))
                nbytes += flat.numel() * flat.element_size()
            if recvs.get(q):
                specs = recvs[q]
                numel = sum(math.prod(sh) for sh, _, _ in specs)
                dtype = specs[0][1]
                buf = self._pinned(("swap-recv", q), numel, dtype) \
                    if torch.device(specs[0][2]).type == "cuda" \
                    else torch.empty(numel, dtype=dtype)
                posts.append((dist.irecv, buf, q))
                landed.append((q, buf, specs))
        with _Timed(nbytes):
            _post(posts)
        out = {}
        for q, buf, specs in landed:
            parts = buf.split([math.prod(sh) for sh, _, _ in specs])
            # a pinned buffer is this span's, reused: copy out of it
            out[q] = [p.view(sh).to(dev, copy=buf.is_pinned())
                      for p, (sh, _, dev) in zip(parts, specs)]
        return out

    def sum(self, xs):
        """The sum of every member's tensor in global order (``psum``'s
        order), one tensor on the device of ``xs[0]``: the operands
        gathered, then added here, so the arithmetic is this device's
        (gloo's own reduction may treat subnormals otherwise)."""
        xs = list(xs)
        parts = self.gather(xs)
        dev = xs[0].device
        total = parts[0].to(dev)
        for p in parts[1:]:
            total = total + p.to(dev)
        return total

    def psum(self, xs):
        """:func:`psum_ranked` over this span: the ordered sum on every
        local member's device, differentiable."""
        return list(_RankSum.apply(self, *xs))


def _post(posts):
    """Post every ``(op, flat tensor, peer)`` of ``posts`` (``isend`` or
    ``irecv``) in pieces of ``CHUNK_BYTES``, in order, then wait on all:
    no process waits before it has posted everything, so two processes
    cannot wait on each other."""
    reqs = []
    for op, t, peer in posts:
        step = max(1, CHUNK_BYTES // t.element_size())
        for off in range(0, t.numel(), step):
            reqs.append(op(t.narrow(0, off, min(step, t.numel() - off)),
                           peer))
    for w in reqs:
        w.wait()


def _rotate(span, shift, groups):
    """Member ``i``'s tensor of each list of ``groups`` (this process's
    members, ``span.local``) to member ``(i + shift) % n``: a pair whose
    two ends are here by ``.to``, the others in one :meth:`Span.swap`.
    Both ends walk the pairs in the order of their source, so a sender
    packs what its peer unpacks in the same order."""
    n, local = span.n, span.local
    at = {m: j for j, m in enumerate(local)}
    out = [[None] * len(local) for _ in groups]
    sends, recvs, land = {}, {}, {}
    for src in range(n):
        dst = (src + shift) % n
        s_mine, d_mine = src in at, dst in at
        if s_mine and d_mine:
            for g, xs in enumerate(groups):
                out[g][at[dst]] = xs[at[src]].to(xs[at[dst]].device)
        elif s_mine:
            sends.setdefault(span.owners[dst], []).extend(
                xs[at[src]] for xs in groups)
        elif d_mine:
            q = span.owners[src]
            for g, xs in enumerate(groups):
                x = xs[at[dst]]
                recvs.setdefault(q, []).append((x.shape, x.dtype, x.device))
                land.setdefault(q, []).append((g, at[dst]))
    got = span.swap(sends, recvs)
    for q, slots in land.items():
        for (g, j), t in zip(slots, got[q]):
            out[g][j] = t
    return out


class _RingHop(torch.autograd.Function):
    """:func:`ring_hop` across processes: every local member's tensors of
    every group in ONE node, so each process's graph holds the same nodes
    in the same order; the backward rotates the gradients back."""

    @staticmethod
    def forward(ctx, span, shift, ngroups, *xs):
        ctx.span, ctx.shift, ctx.ngroups = span, shift, ngroups
        k = len(xs) // ngroups
        out = _rotate(span, shift, [xs[g * k:(g + 1) * k]
                                    for g in range(ngroups)])
        return tuple(t for ts in out for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        k = len(gs) // ctx.ngroups
        back = _rotate(ctx.span, -ctx.shift,
                       [gs[g * k:(g + 1) * k] for g in range(ctx.ngroups)])
        return (None, None, None) + tuple(t for ts in back for t in ts)


def _exchange_pieces(span, xs, split_axis, concat_axis, tiled):
    """The tiled or untiled ``all_to_all`` of this process's members
    ``xs`` over ``span``: local pieces by ``.to``, the others in one
    :meth:`Span.swap` (member i's pieces for the members of process q,
    i outer, in global order on both ends)."""
    n, local = span.n, span.local
    at = {m: j for j, m in enumerate(local)}
    pieces = _pieces(xs, n, split_axis, tiled)
    got = {i: pieces[at[i]] for i in local}  # got[i][j]: i's piece for j
    peers = {}
    for i, q in enumerate(span.owners):
        if i not in at:
            peers.setdefault(q, []).append(i)
    sends = {q: [got[i][j] for i in local for j in members]
             for q, members in peers.items()}
    recvs = {q: [(pieces[0][0].shape, xs[at[j]].dtype, xs[at[j]].device)
                 for i in members for j in local]
             for q, members in peers.items()}
    came = span.swap(sends, recvs)
    for q, members in peers.items():
        it = iter(came[q])
        for i in members:
            got[i] = {j: next(it) for j in local}
    return [_join([got[i][j].to(xs[at[j]].device) for i in range(n)],
                  concat_axis, tiled) for j in local]


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all` across processes: one node over every local
    member; the backward is the inverse exchange of the gradients (the
    split and concatenation axes swapped)."""

    @staticmethod
    def forward(ctx, span, split_axis, concat_axis, tiled, *xs):
        ctx.args = (span, split_axis, concat_axis, tiled)
        return tuple(_exchange_pieces(span, xs, split_axis, concat_axis,
                                      tiled))

    @staticmethod
    def backward(ctx, *gs):
        span, split_axis, concat_axis, tiled = ctx.args
        return (None,) * 4 + tuple(_exchange_pieces(
            span, gs, concat_axis, split_axis, tiled))


class _RankSum(torch.autograd.Function):
    """The sum of a span's members in global order, one output a local
    member; the backward sums the outputs' gradients in the same order
    (each member's own gradient, which autograd would otherwise add up in
    the order of its consumers)."""

    @staticmethod
    def forward(ctx, span, *xs):
        ctx.span = span
        ctx.devs = [x.device for x in xs]
        total = span.sum(xs)
        return tuple(total.to(d, copy=True) for d in ctx.devs)

    @staticmethod
    def backward(ctx, *gs):
        total = ctx.span.sum(gs)
        return (None,) + tuple(total.to(d, copy=True) for d in ctx.devs)


def psum_ranked(xs, span=None):
    """``psum`` of the local members ``xs`` over ``span`` (default: these
    members alone, in one process), added in global order in the forward
    and in the backward, with one output a member."""
    if span is None:
        span = Span([distributed.process_index()] * len(xs))
    return span.psum(xs)


def process_sum(t):
    """The sum over every process of ``t`` (a small tensor, e.g. a metric
    accumulator), in place; nothing to add in one process."""
    if distributed.process_count() > 1:
        import torch.distributed as dist
        with _Timed(t.numel() * t.element_size()):
            dist.all_reduce(t)
    return t


def process_broadcast(t, src=0):
    """Process ``src``'s ``t`` in every process, in place."""
    if distributed.process_count() > 1:
        import torch.distributed as dist
        with _Timed(t.numel() * t.element_size()):
            dist.broadcast(t, src)
    return t
