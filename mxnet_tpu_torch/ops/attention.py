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
from .registry import OpSpec, Param, register, shape_assign


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
            mask = torch.rand(out.shape, generator=generator,
                              device=out.device) < keep
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

    def forward_ranks(self, p, ins_by_rank, is_train, generators):
        """The forward on every rank of one ring along ``axis_name`` at
        once: ``ins_by_rank[r]`` are rank r's inputs, its data the
        contiguous tokens ``[r T, (r+1) T)``. ``impl="ring"`` rotates K/V
        around the ring; ``"ring_striped"`` re-deals the tokens
        round-robin with one all_to_all, runs the striped ring (the
        ``striped_pair_attention`` kernel) and deals back. Returns each
        rank's outputs."""
        from ..parallel import collectives
        from ..parallel.ring import _ring_attention_local, _striped_ring_local
        self._validate(p)
        n = len(ins_by_rank)
        t = ins_by_rank[0][0].shape[1]
        qkv = [self._project(p, ins, r * t)
               for r, ins in enumerate(ins_by_rank)]
        qs, ks, vs = (list(z) for z in zip(*qkv))
        if p["impl"] == "ring":
            os_ = _ring_attention_local(qs, ks, vs, causal=p["causal"],
                                        scale=None)
        else:
            if t % n:
                raise MXNetError(
                    "impl='ring_striped': local length %d not divisible "
                    "by ring size %d" % (t, n))
            b, _, h, d = qs[0].shape

            def deal(zs):  # contiguous shards -> striped shards
                zs = [z.reshape(b, t // n, n, h, d).transpose(1, 2)
                      for z in zs]
                return [z.reshape(b, t, h, d)
                        for z in collectives.all_to_all(zs, 1, 1)]

            def undeal(zs):  # striped shards -> contiguous shards
                zs = [z.reshape(b, n, t // n, h, d) for z in zs]
                return [z.transpose(1, 2).reshape(b, t, h, d)
                        for z in collectives.all_to_all(zs, 1, 1)]

            os_ = undeal(_striped_ring_local(deal(qs), deal(ks), deal(vs),
                                             scale=None))
        return [[self._output(p, o, ins, is_train, g)]
                for o, ins, g in zip(os_, ins_by_rank, generators)]
