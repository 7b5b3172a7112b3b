"""Weight-only int8/int4 quantization for serving.

Counterpart of ``mxnet_tpu/serving/quant.py`` (l.74-457). Every
quantizable LM weight contracts over its LAST axis (``qkv_weight``/
``out_weight`` ``[F, E]``, FullyConnected ``[out, in]``, Embedding
``[vocab, E]``, the MoE gate ``[X, E]`` and expert stacks ``[X, H, E]`` /
``[X, E, H]``), so:

* int8: symmetric per-output-channel, ``scale = amax(|w|, -1) / 127``
  (all-zero rows get 1), ``q = round(w / scale)``; the scale multiplies
  the product, after the dot.
* int4: symmetric per group of ``group`` contraction elements,
  ``scale = amax / 7``, two values packed per byte (low nibble = even
  element); the scales multiply the weight, before the dot.

Values, packed nibbles and scales are bitwise those of the JAX package
on the same f32 weights (f32 division and round-half-to-even on both
sides). LayerNorm gains, biases and positional tables stay float.
``MXNET_QUANT_GROUP`` and ``MXNET_QUANT_CHUNK`` set the int4 group and
the plain product's chunk as in the JAX package.
"""
from __future__ import annotations

import os

import torch

from ..base import MXNetError, torch_dtype
from ..ops.kernels import quant_matmul_plain, unpack4

__all__ = ["QuantizedTensor", "quantize_tensor", "dequantize",
           "quantized_weight_names", "quantize_params",
           "scale_fused_matmul", "pack_int4", "unpack_int4",
           "resolve_chunk", "resolve_group", "embedding_rows",
           "expert_slice", "moe_ffn_forward", "weight_nbytes"]

# op name -> input indices that are quantizable matmul weights; every
# OTHER consumer position vetoes quantization of its variable
_QUANT_ARGS = {
    "FullyConnected": (1,),
    "Embedding": (1,),
    "MultiHeadAttention": (1, 3),          # qkv_weight, out_weight
    "MoEFFN": (1, 2, 4),                   # gate, expert_w1, expert_w2
}


class QuantizedTensor:
    """A quantized weight with f32 scales.

    ``bits=8``: ``q`` int8 in the weight's shape, ``scale`` f32 of shape
    ``q.shape[:-1]``. ``bits=4``: ``q`` uint8 ``[..., E//2]`` (two values
    per byte along the contraction axis), ``scale`` f32
    ``[..., E//group]``. ``dtype`` is the dequantization target (the
    float weight's own dtype)."""

    __slots__ = ("q", "scale", "dtype", "bits", "group")

    def __init__(self, q, scale, dtype, bits=8, group=None):
        self.q = q
        self.scale = scale
        self.dtype = dtype
        self.bits = bits
        self.group = group

    @property
    def shape(self):
        if self.bits == 4:
            return tuple(self.q.shape[:-1]) + (2 * self.q.shape[-1],)
        return tuple(self.q.shape)

    @property
    def nbytes(self):
        return self.q.numel() * self.q.element_size() \
            + self.scale.numel() * self.scale.element_size()

    def __repr__(self):
        return ("QuantizedTensor(shape=%r, dtype=%s, bits=%d%s)"
                % (self.shape, self.dtype, self.bits,
                   "" if self.group is None else ", group=%d" % self.group))


def pack_int4(q):
    """Pack 4-bit values (range [-8, 7]) pairwise along the last axis
    into uint8: byte ``i`` holds element ``2i`` in its low nibble and
    ``2i+1`` in its high nibble. Exact inverse of :func:`unpack_int4`."""
    q = torch.as_tensor(q).to(torch.int32)
    lo = (q[..., 0::2] & 0xF).to(torch.uint8)
    hi = (q[..., 1::2] & 0xF).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(u, dtype=torch.int8):
    """Unpack :func:`pack_int4` bytes back to signed 4-bit values
    ``[..., 2*E2]``."""
    return unpack4(torch.as_tensor(u)).to(dtype)


def resolve_group(n, group=None):
    """The per-group scale width for a contraction axis of size ``n``
    under int4. ``group=None`` reads ``MXNET_QUANT_GROUP`` (unset: auto,
    the largest of (128, 64, 32, 16, 8, 4, 2) dividing ``n``); an explicit
    group must be an even divisor of ``n`` or it raises."""
    if group is None:
        env = os.environ.get("MXNET_QUANT_GROUP", "").strip()
        group = int(env) if env else None
    if group is None:
        for g in (128, 64, 32, 16, 8, 4, 2):
            if n % g == 0:
                return g
        raise MXNetError(
            "int4 quantization needs an even contraction axis to pack "
            "nibble pairs, got axis size %d" % n)
    group = int(group)
    if group <= 0 or group % 2 or n % group:
        raise MXNetError(
            "MXNET_QUANT_GROUP=%d must be a positive even divisor of "
            "the contraction axis (%d here); pick a divisor or unset "
            "it for the auto choice" % (group, n))
    return group


def quantize_tensor(w, dtype=None, bits=8, group=None):
    """Quantize one float weight (rank >= 2) to :class:`QuantizedTensor`;
    ``dtype`` is the dequant target (default: ``w``'s own dtype)."""
    w = torch.as_tensor(w)
    if w.dim() < 2:
        raise MXNetError(
            "quantize_tensor: per-output-channel quantization needs a "
            "rank >= 2 weight, got shape %r" % (tuple(w.shape),))
    dtype = w.dtype if dtype is None else torch_dtype(dtype)
    wf = w.to(torch.float32)
    if bits == 8:
        s = wf.abs().amax(dim=-1) / 127.0
        s = torch.where(s > 0, s, torch.ones_like(s))
        q = torch.round(wf / s[..., None]).to(torch.int8)
        return QuantizedTensor(q, s, dtype)
    if bits != 4:
        raise MXNetError("quantize_tensor: bits must be 8 or 4, got %r"
                         % (bits,))
    e = w.shape[-1]
    g = resolve_group(e, group)
    wg = wf.reshape(tuple(wf.shape[:-1]) + (e // g, g))
    s = wg.abs().amax(dim=-1) / 7.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    q4 = torch.round(wg / s[..., None]).to(torch.int32).reshape(wf.shape)
    return QuantizedTensor(pack_int4(q4), s, dtype, bits=4, group=g)


def dequantize(qt):
    """The float weight a :class:`QuantizedTensor` stands for (testing
    and debugging; the serving path never materializes it)."""
    if qt.bits == 4:
        v = unpack4(qt.q)
        return (v * torch.repeat_interleave(qt.scale, qt.group, dim=-1)) \
            .to(qt.dtype)
    return (qt.q.to(torch.float32) * qt.scale[..., None]).to(qt.dtype)


def quantized_weight_names(topo):
    """Parameter names of a node walk consumed ONLY at matmul-weight
    positions of the ops the decoder dequantizes on the fly (attention
    QKV/out projections, FullyConnected weights, Embedding tables)."""
    want, veto = set(), set()
    for n in topo:
        if n.is_var:
            continue
        idxs = _QUANT_ARGS.get(n.spec.name, ())
        for j, (inp, _) in enumerate(n.inputs):
            if not inp.is_var:
                continue
            (want if j in idxs else veto).add(inp.name)
    return want - veto


def quantize_params(params, names, bits=8, group=None, row_quant=()):
    """Quantize ``names`` of a parameter dict (each keeps its dtype as the
    dequant target); names in ``row_quant`` (Embedding tables, gathered
    by rows) stay per-row int8 under ``bits=4``."""
    def one(k, v):
        if k not in names:
            return v
        b = 8 if k in row_quant else bits
        return quantize_tensor(v, bits=b, group=group)
    return {k: one(k, v) for k, v in params.items()}


def _block_rows(f):
    """Default output-channel chunk height of the plain product: the
    largest of (256 .. 8) dividing ``f`` into at least 8 chunks, else at
    least 2, else None (dequantize whole)."""
    for least in (8, 2):
        for r in (256, 128, 64, 32, 16, 8):
            if f % r == 0 and f // r >= least:
                return r
    return None


def resolve_chunk(f):
    """Output-channel chunk for a weight with ``f`` output rows (None =
    dequantize whole). ``MXNET_QUANT_CHUNK`` overrides the
    :func:`_block_rows` pick (``0`` or unset: the auto pick); a value that
    does not divide ``f`` raises, and one ``>= f`` means whole."""
    env = os.environ.get("MXNET_QUANT_CHUNK", "").strip()
    if not env or env == "0":
        return _block_rows(f)
    try:
        r = int(env)
    except ValueError:
        raise MXNetError(
            "MXNET_QUANT_CHUNK=%r is not an integer chunk size" % env)
    if r < 0 or (r < f and f % r):
        raise MXNetError(
            "MXNET_QUANT_CHUNK=%d must divide the weight's output-"
            "channel count (%d here): the chunk walk partitions "
            "output rows exactly; pick a divisor or 0 for the auto "
            "choice" % (r, f))
    return None if r >= f else r


def scale_fused_matmul(x, qt):
    """``x [..., E] @ qt [F, E]^T`` -> ``[..., F]`` in x's dtype: the
    plain product of ``matmul_impl="dense"``, walking output-channel
    chunks (:func:`resolve_chunk`) so the dequantized staging is one
    chunk, not one weight. Chunking partitions independent output
    channels; it never splits a sum."""
    f = qt.q.shape[0]
    x2 = x.reshape(-1, x.shape[-1])
    r = resolve_chunk(f) or f
    parts = [quant_matmul_plain(x2, qt.q[i:i + r], qt.scale[i:i + r],
                                qt.bits, qt.group, x.dtype)
             for i in range(0, f, r)]
    return torch.cat(parts, dim=-1).reshape(tuple(x.shape[:-1]) + (f,))


def embedding_rows(qt, idx):
    """Quantized Embedding lookup: gather int8 rows and their scales and
    dequantize only the gathered rows."""
    idx = idx.long()
    rows = qt.q[idx].to(torch.float32)
    return (rows * qt.scale[idx][..., None]).to(qt.dtype)


def expert_slice(qt, i):
    """Expert ``i`` of a stacked MoE :class:`QuantizedTensor` (``[X, out,
    contract]`` values and their scales) as its own 2-D quantized weight,
    views of the stack."""
    return QuantizedTensor(qt.q[i], qt.scale[i], qt.dtype, bits=qt.bits,
                           group=qt.group)


def _kernel_slice(qt, i):
    """:func:`expert_slice` as the ``quant_matmul`` kernel takes it: its
    vector loads need the values on a 16-byte boundary, so an expert
    whose offset in the stack is not one (per-expert bytes not a multiple
    of 16) is copied into an allocation of its own."""
    w = expert_slice(qt, i)
    if w.q.data_ptr() % 16:
        w = QuantizedTensor(w.q.clone(), w.scale, w.dtype, bits=w.bits,
                            group=w.group)
    return w


def _expert_matmul(h, qt):
    """``h [B, T, X, H] x w2 [X, E, H] -> [B, T, X, E]``: the MoE down
    projection of ``matmul_impl="dense"``, one plain product an expert
    (experts are independent output blocks, so this is the einsum on the
    dequantized stack)."""
    b, t, nx, hh = h.shape
    cols = [quant_matmul_plain(h[:, :, i].reshape(b * t, hh), qt.q[i],
                               qt.scale[i], qt.bits, qt.group, h.dtype)
            for i in range(nx)]
    return torch.stack(cols, dim=1).reshape(b, t, nx, -1)


def moe_ffn_forward(p, ins, mm=None, ep=None):
    """MoEFFN forward with any mix of quantized and float weights: the
    routing and combine of ``ops.attention.moe_ffn_math``, the float op's
    own, with the product of each quantized weight swapped for its
    quantized form (the JAX package's l.411-457).

    ``mm`` (optional) replaces :func:`scale_fused_matmul` for the 2-D
    quantized products: the decoder passes the ``quant_matmul`` kernel
    under ``matmul_impl="pallas"``/``"fused"``. Then the gate is one
    product ``[X, E]``, the up projection one over the stack's flattened
    ``[X*H, E]`` view, and the down projection one product an expert,
    over that expert's rows of ``h`` (one copy of ``h`` puts each
    expert's rows together, as the kernel takes contiguous operands).
    ``ep=(axis_name, n)``: the stacks arrive as lists of rank shards
    (:func:`~mxnet_tpu_torch.ops.attention.moe_ffn_math`)."""
    from ..ops.attention import moe_ffn_math
    qmm = mm if mm is not None else scale_fused_matmul

    def gate_mm(x, w):
        if isinstance(w, QuantizedTensor):
            return qmm(x, w)
        return torch.einsum("bte,xe->btx", x, w)

    def up_mm(x, w):
        if not isinstance(w, QuantizedTensor):
            return torch.einsum("bte,xhe->btxh", x, w)
        # [X, H, E] contracts E with output channels (x, h): the 2-D
        # product over the flattened [X*H, E] view
        xq, hq = w.q.shape[:2]
        flat = QuantizedTensor(
            w.q.reshape((xq * hq,) + tuple(w.q.shape[2:])),
            w.scale.reshape((xq * hq,) + tuple(w.scale.shape[2:])),
            w.dtype, bits=w.bits, group=w.group)
        return qmm(x, flat).reshape(tuple(x.shape[:-1]) + (xq, hq))

    def down_mm(h, w):
        if not isinstance(w, QuantizedTensor):
            return torch.einsum("btxh,xeh->btxe", h, w)
        if mm is None:
            return _expert_matmul(h, w)
        hx = h.movedim(2, 0).contiguous()          # [X, B, T, H]
        return torch.stack([mm(hx[i], _kernel_slice(w, i))
                            for i in range(w.q.shape[0])], dim=2)

    return moe_ffn_math(p, ins, gate_mm=gate_mm, up_mm=up_mm,
                        down_mm=down_mm, ep=ep)


def weight_nbytes(params):
    """Total stored bytes of a parameter dict (quantized entries count
    their int8/int4 values + scales; an ep-sharded entry, a list of rank
    shards, counts every shard) — the ``serving.weight_bytes`` gauge."""
    def one(v):
        if isinstance(v, (list, tuple)):
            return sum(one(s) for s in v)
        if isinstance(v, dict):
            return sum(one(s) for s in v.values())
        if isinstance(v, QuantizedTensor):
            return v.nbytes
        return v.numel() * v.element_size()
    return int(one(params))
