"""Long-context attention: blockwise (flash) and ring sequence parallelism.

Counterpart of ``mxnet_tpu/parallel/ring.py`` (l.52-285). Sequences are
sharded over the ``sp`` mesh axis and attention runs as a ring: each rank
holds a query block, and the key/value blocks rotate around the ring
(``collectives.ring_hop``, one hop per step) while a streaming-softmax
accumulator folds each block in. The JAX package runs one program per
device under ``shard_map``; here one process drives every rank of the ring
it owns in lockstep (``parallel/mesh.py``), so the per-rank bodies take
the LIST of those ranks' shards of one ring and their ring positions; a
ring across processes hops through its ``collectives.Span``.

``ring_attention`` keeps the contiguous layout; ``striped_ring_attention``
is the balanced form for causal attention: tokens are dealt round-robin
(rank i holds positions {a*n + i}), so at every hop each rank faces a
near-triangle mask of the same size, and the hop runs the
``striped_pair_attention`` kernel, which skips the key tiles above the
striped diagonal; the hops' (o, lse) partials merge by ``logaddexp``.
The contiguous ring and ``blockwise_attention`` reach no kernel: their
products are ``torch.einsum``. All softmax state is f32.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops import kernels
from .collectives import ring_hop

__all__ = ["blockwise_attention", "ring_attention", "ring_self_attention",
           "striped_ring_attention"]


def _block_update(q, k, v, o, l, m, mask, scale):
    """Fold one K/V block into the streaming-softmax state.

    q: [B,Tq,H,D]  k,v: [B,Tk,H,D]  o: [B,Tq,H,D] f32
    l,m: [B,H,Tq] f32.  mask: [Tq,Tk] bool or None (True = attend).
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    neg_inf = torch.tensor(float("-inf"), device=s.device)
    if mask is not None:
        s = torch.where(mask[None, None], s, neg_inf)
    new_m = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows: exp(-inf - -inf) -> use a safe max
    safe_m = torch.where(torch.isneginf(new_m), torch.zeros_like(new_m),
                         new_m)
    p = torch.exp(s - safe_m[..., None])
    if mask is not None:
        p = torch.where(mask[None, None], p, torch.zeros_like(p))
    correction = torch.exp(torch.where(torch.isneginf(m), neg_inf, m)
                           - safe_m)
    correction = torch.where(torch.isneginf(m), torch.zeros_like(correction),
                             correction)
    new_l = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    new_o = o * correction.transpose(1, 2)[..., None] + pv
    return new_o, new_l, new_m


def _finalize(o, l):
    l = torch.clamp(l, min=1e-30)
    return o / l.transpose(1, 2)[..., None]


def _init_state(q):
    b, t, h, d = q.shape
    return (torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device),
            torch.zeros((b, h, t), dtype=torch.float32, device=q.device),
            torch.full((b, h, t), float("-inf"), dtype=torch.float32,
                       device=q.device))


def blockwise_attention(q, k, v, *, causal=False, block_size=512,
                        scale=None, window=0):
    """Memory-efficient attention on one device: K/V consumed in blocks by
    the flash recurrence, so peak memory is O(T·block) instead of O(T²).
    Shapes: [B,T,H,D] each; returns [B,T,H,D] in q.dtype. ``window``>0
    additionally masks keys more than ``window-1`` positions behind their
    query (sliding-window attention; requires ``causal``)."""
    tq, tk, d = q.shape[1], k.shape[1], q.shape[3]
    if window < 0:
        raise ValueError("blockwise_attention: window must be >= 0, "
                         "got %d" % window)
    if window and not causal:
        raise ValueError("blockwise_attention: window>0 requires causal")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qpos = torch.arange(tq, device=q.device)
    o, l, m = _init_state(q)
    for start in range(0, tk, block_size):
        stop = min(start + block_size, tk)
        kpos = torch.arange(start, stop, device=q.device)
        if causal:
            mask = qpos[:, None] >= kpos[None, :]
            if window:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
        else:
            mask = None
        o, l, m = _block_update(q, k[:, start:stop], v[:, start:stop], o, l,
                                m, mask, scale)
    return _finalize(o, l).to(q.dtype)


def _ring_of(qs, pos, span):
    """(ring size, the ring positions of the ranks of ``qs``)."""
    n = span.n if span is not None else len(qs)
    return n, list(range(len(qs))) if pos is None else list(pos)


def _ring_attention_local(qs, ks, vs, *, causal, scale, pos=None,
                          span=None):
    """The ring body over one ring's ranks: qs, ks, vs are the LOCAL
    sequence shards [B, T/n, H, D] of the ranks at ring positions ``pos``
    (default 0..n-1; rank r holds positions [r T/n, (r+1) T/n)). K/V
    rotate the ring; streaming softmax folds each arriving block in.
    ``span`` (a ``collectives.Span`` over the ring): the ring's other
    ranks live in other processes, ``pos`` are this process's ranks'
    GLOBAL positions, and the hops cross (``collectives.ring_hop``).
    Returns the ranks' outputs."""
    n, pos = _ring_of(qs, pos, span)
    tq, tk, d = qs[0].shape[1], ks[0].shape[1], qs[0].shape[3]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    state = [_init_state(q) for q in qs]
    kcur, vcur = list(ks), list(vs)
    for i in range(n):
        for j, my in enumerate(pos):
            src = (my - i) % n  # ring position whose K/V block `my` holds
            dev = qs[j].device
            if causal:
                qpos = my * tq + torch.arange(tq, device=dev)
                kpos = src * tk + torch.arange(tk, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
            else:
                mask = None
            state[j] = _block_update(qs[j], kcur[j], vcur[j], *state[j],
                                     mask, scale)
        if i < n - 1:
            kcur, vcur = ring_hop([kcur, vcur], span=span)
    return [_finalize(o, l).to(q.dtype) for (o, l, _), q in zip(state, qs)]


def _striped_ring_local(qs, ks, vs, *, scale, block_q=None, block_k=None,
                        pos=None, span=None):
    """The striped ring body over one ring's ranks: qs, ks, vs are the
    STRIPED shards [B, C, H, D] of the ranks at ring positions ``pos``
    (default 0..n-1; local row ``a`` of rank ``my`` is global position
    ``a*n + my``). Each hop runs the ``striped_pair_attention`` kernel for
    every rank, with the ring positions ``(my, (my - i) % n)`` as host
    ints, and merges the (o, lse) partial with streaming softmax;
    ``block_q``/``block_k`` go to every hop. ``span``: as
    :func:`_ring_attention_local`'s. Returns the ranks' outputs."""
    n, pos = _ring_of(qs, pos, span)
    b, c, h, d = qs[0].shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)

    def to_bh(x):  # the kernel's contiguous [B*H, C, D] (a copy unless B=1)
        return x.transpose(1, 2).reshape(b * h, c, d).contiguous()

    qb = [to_bh(q) for q in qs]
    o = [torch.zeros((b * h, c, d), dtype=torch.float32, device=q.device)
         for q in qs]
    lse = [torch.full((b * h, c, 1), -1e30, dtype=torch.float32,
                      device=q.device) for q in qs]
    kcur, vcur = [to_bh(k) for k in ks], [to_bh(v) for v in vs]
    for i in range(n):
        for j, my in enumerate(pos):
            src = (my - i) % n  # ring position of this K/V block
            o_i, lse_i = kernels.striped_pair_attention(
                qb[j], kcur[j], vcur[j], my, src, n_stride=n, scale=scale,
                block_q=block_q, block_k=block_k)
            new_lse = torch.logaddexp(lse[j], lse_i)
            o[j] = o[j] * torch.exp(lse[j] - new_lse) \
                + o_i.float() * torch.exp(lse_i - new_lse)
            lse[j] = new_lse
        if i < n - 1:
            kcur, vcur = ring_hop([kcur, vcur], span=span)
    return [x.reshape(b, h, c, d).transpose(1, 2).to(q.dtype)
            for x, q in zip(o, qs)]


def _rings(mesh, axis_name, batch_axis):
    """The devices of each ring: one ring along ``axis_name`` per shard of
    the batch over ``batch_axis``; any other mesh axis replicates, and its
    first coordinate computes."""
    for ax in (axis_name, batch_axis):
        if ax is not None and ax not in mesh.shape:
            raise MXNetError("mesh %s has no axis %r" % (mesh.shape, ax))
    nb = mesh.shape[batch_axis] if batch_axis else 1
    rings = []
    for bi in range(nb):
        idx = tuple(slice(None) if a == axis_name else
                    (bi if a == batch_axis else 0) for a in mesh.axis_names)
        rings.append(list(mesh.devices[idx]))
    return rings


def _run_rings(body, arrays, mesh, axis_name, batch_axis):
    """Shard each GLOBAL [B, T, ...] array (B over ``batch_axis``, T over
    ``axis_name``) onto its ranks, run ``body`` on each ring's shard lists
    and gather the ranks' outputs back onto the first array's device."""
    rings = _rings(mesh, axis_name, batch_axis)
    n = len(rings[0])
    b, t = arrays[0].shape[:2]
    if b % len(rings) or t % n:
        raise MXNetError("global shape %s not divisible by mesh %s"
                         % (tuple(arrays[0].shape), mesh.shape))
    home = arrays[0].device
    out = []
    for devs, bpart in zip(rings, range(len(rings))):
        lists = []
        for x in arrays:
            xb = x.chunk(len(rings), dim=0)[bpart]
            lists.append([s.to(dev) for s, dev in zip(xb.chunk(n, dim=1),
                                                       devs)])
        outs = body(*lists)
        out.append(torch.cat([o.to(home) for o in outs], dim=1))
    return torch.cat(out, dim=0)


def ring_attention(q, k, v, mesh, *, axis_name="sp", causal=False,
                   scale=None, batch_axis=None):
    """Ring attention over the ``axis_name`` mesh axis.

    q,k,v: GLOBAL [B,T,H,D] tensors; T is sharded over ``axis_name`` (and
    B over ``batch_axis``, when given) onto the mesh's devices, and the
    result is gathered back onto q's device. Differentiable."""
    def body(qs, ks, vs):
        return _ring_attention_local(qs, ks, vs, causal=causal, scale=scale)
    return _run_rings(body, (q, k, v), mesh, axis_name, batch_axis)


def striped_ring_attention(q, k, v, mesh, *, axis_name="sp", scale=None,
                           batch_axis=None, block_q=None, block_k=None):
    """Causal ring attention with the STRIPED token layout: balanced
    per-hop work through the ``striped_pair_attention`` kernel.

    q,k,v: GLOBAL [B,T,H,D] in NATURAL token order. The tokens are dealt
    round-robin onto the ring, the balanced ring runs, and the output comes
    back in natural order. Causal only: striping exists to balance the
    causal mask. ``block_q``/``block_k`` go to every hop's
    ``striped_pair_attention``, whose tiles on CUDA are fixed: validated
    there, they change nothing."""
    n = len(_rings(mesh, axis_name, batch_axis)[0])
    b, t, h, d = q.shape
    if t % n:
        raise ValueError("striped ring: T=%d not divisible by ring size %d"
                         % (t, n))
    c = t // n

    def stripe(x):
        # natural [B, T] -> striped [B, T']: chunk j holds {a*n + j}
        return x.reshape(b, c, n, h, d).transpose(1, 2).reshape(b, t, h, d)

    def unstripe(x):
        return x.reshape(b, n, c, h, d).transpose(1, 2).reshape(b, t, h, d)

    def body(qs, ks, vs):
        return _striped_ring_local(qs, ks, vs, scale=scale, block_q=block_q,
                                   block_k=block_k)
    return unstripe(_run_rings(body, (stripe(q), stripe(k), stripe(v)),
                               mesh, axis_name, batch_axis))


def ring_self_attention(x, wq, wk, wv, wo, mesh, *, num_heads,
                        axis_name="sp", causal=True, batch_axis="dp"):
    """Full self-attention block with a ring-parallel sequence dim.

    x: [B,T,E] (T sharded on ``axis_name``); wq/wk/wv/wo: [E,E]. The
    QKV/output projections are position-wise and need no communication
    under sequence sharding; only the ring rotates K/V."""
    b, t, e = x.shape
    d = e // num_heads
    q = (x @ wq).reshape(b, t, num_heads, d)
    k = (x @ wk).reshape(b, t, num_heads, d)
    v = (x @ wv).reshape(b, t, num_heads, d)
    o = ring_attention(q, k, v, mesh, axis_name=axis_name, causal=causal,
                       batch_axis=batch_axis)
    return o.reshape(b, t, e) @ wo
