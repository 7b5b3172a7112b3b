"""Attention and normalization operators.

Counterpart of ``mxnet_tpu/ops/attention.py``: ``LayerNorm`` (l.21),
``PositionalEmbedding`` (l.49), ``rope_rotate`` (l.199) and
``MultiHeadAttention`` (l.221) with its full-sequence forward (l.334)
through the ``flash_attention`` kernel, dense or blockwise attention, and
the sequence-parallel ring impls (l.420-463), which run on all the ranks
of a ring at once (``forward_ranks``, called by the SPMD walk of
``parallel/graph.py``). The decoder never calls that forward: it reads the
cache through the paged and fused kernels instead.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from . import kernels
from .registry import OpSpec, Param, keep_mask, register, shape_assign


@register
class LayerNorm(OpSpec):
    """Layer normalization over the trailing axis: gamma/beta learnable."""

    name = "LayerNorm"
    params = {"eps": Param("float", 1e-5)}

    def arguments(self, p):
        return ["data", "gamma", "beta"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return list(in_shapes), [None], []
        c = (d[-1],)
        return [d, shape_assign(in_shapes[1], c, "LayerNorm gamma"),
                shape_assign(in_shapes[2], c, "LayerNorm beta")], [d], []

    def forward(self, p, ins, aux, is_train, generator):
        # (x - mean) * rsqrt(biased var + eps) * gamma + beta, as the JAX
        # package computes it, in one library call
        x, gamma, beta = ins
        return [torch.nn.functional.layer_norm(
            x, (x.shape[-1],), gamma.to(x.dtype), beta.to(x.dtype),
            p["eps"])], []


@register
class PositionalEmbedding(OpSpec):
    """out = data + pos[None, :, :] — learned additive positional
    embedding. data: [B, T, E]; pos: [T, E] (a parameter)."""

    name = "PositionalEmbedding"
    params = {}

    def arguments(self, p):
        return ["data", "pos"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        ins = list(in_shapes)
        if d is not None:
            if len(d) != 3:
                raise MXNetError("PositionalEmbedding: data must be "
                                 "[B, T, E]")
            ins[1] = shape_assign(in_shapes[1], (d[1], d[2]),
                                  "PositionalEmbedding pos")
        return ins, [d], []

    def forward(self, p, ins, aux, is_train, generator):
        return [ins[0] + ins[1][None, :, :]], []


@register
class MoEFFN(OpSpec):
    """Mixture-of-experts position-wise FFN (soft or top-k routing).

    data: [B, T, E]. gate_weight: [X, E] (X = num_experts);
    expert_w1: [X, H, E], expert_b1: [X, H]; expert_w2: [X, E, H],
    expert_b2: [X, E]. out[b,t] = Σ_x gate[b,t,x] · FFN_x(data[b,t]).

    ``top_k=0`` is soft routing (every expert weighs in); ``top_k=k``
    keeps the k largest gates of each token, renormalized among
    themselves, in its static-shaped form: every expert still computes
    every token, and the dropped ones get exactly zero weight. The
    params, shape rules and messages are the JAX package's."""

    name = "MoEFFN"
    params = {"num_experts": Param("int"), "hidden": Param("int"),
              "top_k": Param("int", 0)}

    def arguments(self, p):
        return ["data", "gate_weight", "expert_w1", "expert_b1",
                "expert_w2", "expert_b2"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        ins = list(in_shapes)
        if d is not None:
            if len(d) != 3:
                raise MXNetError("MoEFFN: data must be [B, T, E]")
            e = d[2]
            x, h = p["num_experts"], p["hidden"]
            ins[1] = shape_assign(ins[1], (x, e), "MoEFFN gate_weight")
            ins[2] = shape_assign(ins[2], (x, h, e), "MoEFFN expert_w1")
            ins[3] = shape_assign(ins[3], (x, h), "MoEFFN expert_b1")
            ins[4] = shape_assign(ins[4], (x, e, h), "MoEFFN expert_w2")
            ins[5] = shape_assign(ins[5], (x, e), "MoEFFN expert_b2")
        return ins, [d], []

    def forward(self, p, ins, aux, is_train, generator):
        return [moe_ffn_math(p, ins)], []


# the JAX package's jnp.float32(-1e30), cast to the logits' dtype by the fill
_MASKED = float(torch.tensor(-1e30, dtype=torch.float32))


def _moe_gates(p, logits):
    """The routing weights [B, T, X] from the full gate row: the top-k
    mask (``top_k > 0``), then the softmax over experts. The k kept
    experts are the first k of a stable descending sort, so exactly k are
    kept and ties go to the lower index, as ``lax.top_k`` breaks them
    (``torch.topk`` promises no order among equal values). An expert's
    place in that sort is the count of the logits above it plus that of
    the equal ones at lower indices, so the mask is ``place < k``,
    computed from the [X, X] comparisons of each row without a sort. The
    dropped logits become ``-1e30`` in the logits' dtype; gradients reach
    the kept ones only."""
    k = int(p["top_k"])
    nx = int(p["num_experts"])
    if k > 0:
        if k >= nx:
            raise MXNetError(
                "MoEFFN: top_k=%d must be < num_experts=%d (use "
                "top_k=0 for dense routing)" % (k, nx))
        lg = logits.detach()
        other, me = lg[..., None, :], lg[..., :, None]   # [.., i, j]
        lower = torch.ones((nx, nx), dtype=torch.bool,
                           device=lg.device).tril(-1)   # j < i
        place = ((other > me) | ((other == me) & lower)).sum(-1)
        logits = logits.masked_fill(place >= k, _MASKED)
    return torch.softmax(logits, dim=-1)


def _moe_experts(x, gates, w1, b1, w2, b2, up_mm, down_mm):
    """Each expert of ``w1``..``b2`` weighted by its gate, [B, T, X, E]:
    up + ``b1``, relu, down + ``b2``, times ``gates`` [B, T, X]."""
    up = up_mm(x, w1) if up_mm is not None \
        else torch.einsum("bte,xhe->btxh", x, w1)
    h = torch.relu(up + b1[None, None])
    y = (down_mm(h, w2) if down_mm is not None
         else torch.einsum("btxh,xeh->btxe", h, w2)) + b2[None, None]
    return y * gates[..., None]


def moe_ffn_math(p, ins, gate_mm=None, up_mm=None, down_mm=None,
                 ep=None):
    """The one MoE routing and combine, over its three pluggable products
    (``None``: the plain einsums), as the JAX package's ``moe_ffn_math``:
    the serving path's quantized forms (``serving/quant.py``) plug in
    here, so quantized routing is the float op's.

    The combine ``btxe,btx->bte`` is the gate-weighted expert outputs
    summed over the expert axis, one reduction over all X experts.

    ``ep=(axis_name, n)``: expert parallelism in the single-controller
    form of ``parallel/collectives.py``. Every expert-stacked input (the
    gate rows and the four stacks) arrives as a LIST of n rank shards,
    each with its ``X/n`` experts on its rank's device. Each rank takes
    the data, computes its local logits, and one all-gather rebuilds the
    full gate row before routing; each rank keeps its slice of the
    renormalized gates and computes only its experts. The JAX package
    then adds the ranks' partial sums with a ``psum``, which reassociates
    the sum: in bf16 that rounding changed a greedy stream on the card.
    Here a second all-gather puts the ranks' gate-weighted outputs back
    in expert order and the same reduction as ep = 1 sums them, so the
    output is ep = 1's bitwise wherever each expert's own products are
    (their kernels' split of the contraction depends on the product's
    width, ``kernels.quant_matmul_splits``). Returns the output on rank
    0's device."""
    x, gate_w, w1, b1, w2, b2 = ins
    gmm = gate_mm if gate_mm is not None \
        else (lambda a, w: torch.einsum("bte,xe->btx", a, w))
    if ep is None:
        return _moe_experts(x, _moe_gates(p, gmm(x, gate_w)), w1, b1, w2,
                            b2, up_mm, down_mm).sum(2)
    from ..parallel.collectives import all_gather
    shards = [z if isinstance(z, (list, tuple)) else [z]
              for z in (gate_w, w1, b1, w2, b2)]
    n = len(shards[0])
    if n != int(ep[1]) or any(len(s) != n for s in shards):
        raise MXNetError(
            "MoEFFN: ep=%r wants each expert input as a list of %d rank "
            "shards, got %s" % (tuple(ep), int(ep[1]),
                                [len(s) for s in shards]))
    devs = [b.device for b in shards[2]]
    xs = [x.to(d) for d in devs]
    logits = all_gather([gmm(xr, g) for xr, g in zip(xs, shards[0])],
                        axis=-1, tiled=True)
    outs = []
    for r, (xr, lg) in enumerate(zip(xs, logits)):
        nloc = shards[0][r].shape[0]
        gates = _moe_gates(p, lg)[..., r * nloc:(r + 1) * nloc]
        outs.append(_moe_experts(xr, gates, *(s[r] for s in shards[1:]),
                                 up_mm, down_mm))
    return all_gather(outs, axis=2, tiled=True)[0].sum(2)


def rope_freqs(half, base, device):
    """Rotary frequencies ``base ** (-i / half)`` for i < half, f32."""
    return base ** (-torch.arange(half, dtype=torch.float32,
                                  device=device) / half)


def rope_rotate(x, positions, base=10000.0):
    """Rotary position embedding (half-split form): rotate the two
    halves of each head dim by position-dependent angles. x: [B, T, H, D]
    (D even); positions: [T] absolute positions, or [B, T] when each
    batch row sits at its own clock."""
    half = x.shape[-1] // 2
    ang = positions[..., None].to(torch.float32) \
        * rope_freqs(half, base, x.device)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if ang.dim() == 2:         # positions [T]: broadcast over batch
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                      # positions [B, T]: per-row angles
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


@register
class MultiHeadAttention(OpSpec):
    """Multi-head self-attention with fused QKV projection.

    data: [B, T, E]; qkv_weight [F, E], qkv_bias [F] with
    ``F = E + 2*num_kv_heads*head_dim``, out_weight [E, E], out_bias [E].
    ``num_kv_heads`` (0 = ``num_heads``) is grouped-query attention;
    ``rope`` rotates q/k; ``window`` is sliding-window attention. The
    params, shape rules and JSON form are the JAX package's, so a graph
    saved by either package loads in the other."""

    name = "MultiHeadAttention"
    params = {"num_heads": Param("int"),
              "num_kv_heads": Param("int", 0),
              "causal": Param("bool", True),
              "impl": Param("str", "flash"),
              "dropout": Param("float", 0.0),
              "rope": Param("bool", False),
              "rope_base": Param("float", 10000.0),
              "window": Param("int", 0),
              "axis_name": Param("str", "sp")}

    @staticmethod
    def kv_heads(p):
        kv = p.get("num_kv_heads", 0) or p["num_heads"]
        if kv < 1 or p["num_heads"] % kv:
            raise MXNetError(
                "MultiHeadAttention: num_kv_heads=%d must be a positive "
                "divisor of num_heads=%d" % (kv, p["num_heads"]))
        return kv

    @staticmethod
    def check_head_shards(p, tp, where="tensor-parallel serving"):
        """Refuse when the kv heads do not split evenly over ``tp``
        shards: tensor-parallel serving shards the KV cache and the
        per-head attention on the kv-head dimension, each GQA query
        group on its kv head's shard, so an uneven split would give the
        shards different shapes and cut groups apart."""
        kv = MultiHeadAttention.kv_heads(p)
        if kv % tp:
            raise MXNetError(
                "MultiHeadAttention: %s needs the %d kv head(s) to "
                "divide evenly over tp=%d shards (GQA query groups "
                "must stay whole on their kv head's shard) — use a "
                "tp that divides num_kv_heads" % (where, kv, tp))

    def arguments(self, p):
        return ["data", "qkv_weight", "qkv_bias", "out_weight", "out_bias"]

    def infer_shape(self, p, in_shapes):
        d = in_shapes[0]
        if d is None:
            return list(in_shapes), [None], []
        if len(d) != 3:
            raise MXNetError("MultiHeadAttention: data must be [B, T, E]")
        e = d[2]
        if e % p["num_heads"] != 0:
            raise MXNetError("MultiHeadAttention: %d heads do not divide "
                             "embed dim %d" % (p["num_heads"], e))
        if p["rope"] and (e // p["num_heads"]) % 2:
            raise MXNetError("MultiHeadAttention: rope needs an even "
                             "head dim, got %d" % (e // p["num_heads"]))
        kv = self.kv_heads(p)
        if p.get("window", 0):
            if p["window"] < 1:
                raise MXNetError("MultiHeadAttention: window must be "
                                 ">= 1 (0 disables), got %d"
                                 % p["window"])
            if not p["causal"]:
                raise MXNetError("MultiHeadAttention: window>0 is "
                                 "defined for causal attention only")
        f = e + 2 * kv * (e // p["num_heads"])  # q rows + kv k/v rows
        ins = [d,
               shape_assign(in_shapes[1], (f, e), "qkv_weight"),
               shape_assign(in_shapes[2], (f,), "qkv_bias"),
               shape_assign(in_shapes[3], (e, e), "out_weight"),
               shape_assign(in_shapes[4], (e,), "out_bias")]
        return ins, [d], []

    def _project(self, p, ins, off):
        """q, k, v [B, T, H, D] of one rank's tokens, K/V broadcast to the
        query heads, rope at positions ``off + [0, T)``."""
        x, wqkv, bqkv = ins[:3]
        b, t, e = x.shape
        h = p["num_heads"]
        d = e // h
        kv = self.kv_heads(p)
        qkv = torch.nn.functional.linear(x, wqkv, bqkv)
        # views into qkv (the flash kernels read them in place); split's
        # backward is one concatenation of the three gradients
        q, k, v = qkv.split([e, kv * d, kv * d], dim=-1)
        q = q.reshape(b, t, h, d)
        k = k.reshape(b, t, kv, d)
        v = v.reshape(b, t, kv, d)
        if kv != h:
            # GQA: each K/V head serves its query group; the kernel takes
            # whole buffers, so the repeat is materialized (as in the JAX
            # package's flash path)
            k = k.repeat_interleave(h // kv, dim=2)
            v = v.repeat_interleave(h // kv, dim=2)
        if p["rope"]:
            if d % 2:
                raise MXNetError("MultiHeadAttention: rope needs an even "
                                 "head dim, got %d" % d)
            posv = off + torch.arange(t, device=x.device)
            q = rope_rotate(q, posv, p["rope_base"])
            k = rope_rotate(k, posv, p["rope_base"])
        return q, k, v

    @staticmethod
    def _validate(p):
        """The window and impl combinations the JAX package refuses;
        returns the window."""
        window = p.get("window", 0)
        if window:
            # as infer_shape validates: the forward can run without shape
            # inference, and a negative window would mask every key
            if window < 1:
                raise MXNetError("MultiHeadAttention: window must be "
                                 ">= 1 (0 disables), got %d" % window)
            if not p["causal"]:
                raise MXNetError("MultiHeadAttention: window>0 is "
                                 "defined for causal attention only")
            if p["impl"] in ("ring", "ring_striped"):
                raise MXNetError(
                    "MultiHeadAttention: window>0 is not supported by "
                    "the sp ring impls — short windows don't need "
                    "sequence sharding; use impl='flash'/'blockwise'/"
                    "'dense'")
        if p["impl"] == "ring_striped" and not p["causal"]:
            raise MXNetError("impl='ring_striped' is causal-only — "
                             "striping exists to balance the causal "
                             "mask; use impl='ring' for full attention")
        return window

    @staticmethod
    def _output(p, o, ins, is_train, generator):
        b, t, e = ins[0].shape
        out = torch.nn.functional.linear(o.reshape(b, t, e), ins[3], ins[4])
        if is_train and p["dropout"] > 0.0:
            keep = 1.0 - p["dropout"]
            mask = keep_mask(out.shape, keep, generator, out.device)
            out = torch.where(mask, out / keep, torch.zeros_like(out))
        return out

    def is_collective(self, p):
        """The ring impls attend across the ranks of mesh axis
        ``axis_name``: the SPMD walk calls :meth:`forward_ranks`."""
        return p["impl"] in ("ring", "ring_striped")

    def forward(self, p, ins, aux, is_train, generator):
        impl = p["impl"]
        window = self._validate(p)
        if self.is_collective(p):
            raise MXNetError(
                "MultiHeadAttention impl=%r needs the ranks of mesh axis "
                "%r — train this symbol with SequenceParallelTrainer, or "
                "use impl='flash'/'dense' for single-program execution"
                % (impl, p["axis_name"]))
        q, k, v = self._project(p, ins, 0)
        t, d = q.shape[1], q.shape[3]
        if impl == "flash":
            o = kernels.flash_attention(q, k, v, causal=p["causal"],
                                        window=window)
        elif impl == "blockwise":
            from ..parallel.ring import blockwise_attention
            o = blockwise_attention(q, k, v, causal=p["causal"],
                                    window=window)
        elif impl == "dense":
            s_ = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
            if p["causal"]:
                qpos = torch.arange(t, device=q.device)[:, None]
                kpos = torch.arange(t, device=q.device)[None, :]
                mask = kpos <= qpos
                if window:
                    mask = mask & (qpos - kpos < window)
                s_ = s_.masked_fill(~mask, float("-inf"))
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s_, dim=-1), v)
        else:
            raise MXNetError("MultiHeadAttention: unknown impl %r" % impl)
        return [self._output(p, o, ins, is_train, generator)], []

    def forward_ranks(self, p, ins_by_rank, is_train, generators, pos=None,
                      span=None):
        """The forward on every rank of one ring along ``axis_name`` at
        once: ``ins_by_rank[j]`` are the inputs of the rank at ring
        position ``pos[j]`` (default ``j``), its data the contiguous
        tokens ``[pos[j] T, (pos[j]+1) T)``. ``impl="ring"`` rotates K/V
        around the ring; ``"ring_striped"`` re-deals the tokens
        round-robin with one all_to_all, runs the striped ring (the
        ``striped_pair_attention`` kernel) and deals back. ``span`` (a
        ``collectives.Span`` over the ring): the ring's other ranks live
        in other processes, ``pos`` are the GLOBAL positions of the ranks
        given, and the hops and deals cross through it. Returns each
        rank's outputs."""
        from ..parallel import collectives
        from ..parallel.ring import _ring_attention_local, _striped_ring_local
        self._validate(p)
        n = span.n if span is not None else len(ins_by_rank)
        pos = list(range(len(ins_by_rank))) if pos is None else list(pos)
        t = ins_by_rank[0][0].shape[1]
        qkv = [self._project(p, ins, r * t)
               for r, ins in zip(pos, ins_by_rank)]
        qs, ks, vs = (list(z) for z in zip(*qkv))
        if p["impl"] == "ring":
            os_ = _ring_attention_local(qs, ks, vs, causal=p["causal"],
                                        scale=None, pos=pos, span=span)
        else:
            if t % n:
                raise MXNetError(
                    "impl='ring_striped': local length %d not divisible "
                    "by ring size %d" % (t, n))
            b, _, h, d = qs[0].shape

            def deal(zs):  # contiguous shards -> striped shards
                zs = [z.reshape(b, t // n, n, h, d).transpose(1, 2)
                      for z in zs]
                return [z.reshape(b, t, h, d) for z in
                        collectives.all_to_all(zs, 1, 1, span=span)]

            def undeal(zs):  # striped shards -> contiguous shards
                zs = [z.reshape(b, n, t // n, h, d) for z in zs]
                return [z.transpose(1, 2).reshape(b, t, h, d) for z in
                        collectives.all_to_all(zs, 1, 1, span=span)]

            os_ = undeal(_striped_ring_local(deal(qs), deal(ks), deal(vs),
                                             scale=None, pos=pos,
                                             span=span))
        return [[self._output(p, o, ins, is_train, g)]
                for o, ins, g in zip(os_, ins_by_rank, generators)]
