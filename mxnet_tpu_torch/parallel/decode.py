"""KV-cache autoregressive decoding for Symbol-built transformer LMs.

Counterpart of ``mxnet_tpu/parallel/decode.py`` ``Decoder``: the
incremental program is DERIVED from the LM's own Symbol graph — the
topological walk runs every position-wise op's ``OpSpec.forward``
unchanged, slices ``PositionalEmbedding`` at the current positions and
swaps every ``MultiHeadAttention`` node for a cached variant that writes
the new tokens' K/V into its cache and reads it back. The read is picked
per node in the JAX package's order: a windowed node (``window=``) keeps
a RING of ``window`` rows with each row's absolute position and reads it
and the chunk under one f32 softmax (:meth:`Decoder._window_attn`); an
ordinary node writes into a ``[B, max_len, Hkv, D]`` cache and reads it
through :func:`~mxnet_tpu_torch.ops.kernels.paged_attention` (``attn_impl=
"paged"``; a single decode token with quantized projections and
``matmul_impl="fused"`` through :func:`~mxnet_tpu_torch.ops.kernels.
fused_decode_attention`), or with ``attn_impl="dense"`` through the
online softmax over ``cache_block`` rows for a single token
(:meth:`Decoder._blocked_attn`) and else the dense masked read of all
``max_len`` rows (:meth:`Decoder._dense_attn`). The dense, blocked and
ring reads are plain PyTorch, as the JAX package computes them outside
any Pallas kernel.

The decoder runs eagerly: ``generate`` and ``beam_search`` are Python
loops, and the cache is updated IN PLACE (one buffer per node for the life
of the cache instead of a donated copy per step; :meth:`Decoder.
clone_cache` keeps a branch point). The serving engine runs the same walk
inside its compiled programs (``parallel.program``), with
:func:`sample_tokens` over :func:`uniform_draw`, the draw as a pure
function of (seed, position), together with the slot-addressed forms
below: the prefix copy's row reads and writes, the speculative verify
step and the draft model's proposal.

Tensor-parallel serving (``tp=("model", n)`` on the walk) runs over a
cache sharded on its kv heads (``init_cache(kv_sharding=)``: one tp=1
layout tree a rank, each with ``Hkv/n`` heads and its own copy of the
ring positions): every position-wise op runs once at tp=1's shapes, and
each attention node hands each rank its contiguous block of heads, writes
and reads that rank's shard through the same read as tp=1, and gathers
the ranks' outputs on the head axis (one collective a node). Expert
parallelism (``ep=("expert", n)`` on the walk, which composes with ``tp``)
hands each MoE node its stacks as lists of rank shards: every rank routes
on the all-gathered gate row and computes its own experts, and ep=1's
reduction sums their gathered outputs (``ops.attention.moe_ffn_math``).
"""
from __future__ import annotations

import math
import os
import warnings

import torch

from ..base import MXNetError, torch_dtype
from ..context import resolve_device
from ..ndarray import _tensor_of
from ..ops import kernels
from ..ops.attention import MultiHeadAttention as _MHA, rope_rotate
from ..serving.quant import (QuantizedTensor, embedding_rows,
                             moe_ffn_forward, quantize_params,
                             quantized_weight_names, resolve_group,
                             scale_fused_matmul)
from .collectives import all_gather
from .shard import NamedSharding, PartitionSpec

__all__ = ["Decoder", "rank_trees", "sample_tokens", "uniform_draw"]

# ops whose forward acts independently per position on [B, C, ...] data
_POSITIONWISE = {
    "Embedding", "LayerNorm", "FullyConnected", "Activation", "LeakyReLU",
    "MoEFFN", "Dropout", "BlockGrad", "Cast", "ElementWiseSum",
    "_Plus", "_Minus", "_Mul", "_Div", "_PlusScalar", "_MinusScalar",
    "_MulScalar", "_DivScalar", "_RMinusScalar", "_RDivScalar",
}
_TEMPORAL = {"MultiHeadAttention", "PositionalEmbedding"}
_LOSS_HEADS = {"SoftmaxOutput", "SoftmaxCELoss"}
# what a fresh cache buffer holds, by its rank: ring positions ([B, W]) -1
# (never written), int8 row scales ([B, L, H]) one, K/V zero
CACHE_FILL = {2: -1, 3: 1, 4: 0}


def _logits_symbol(symbol):
    """Re-head a loss-ended LM at its [B, T, V] logits: strip the loss
    node, then the layout ops the loss variants insert between the head
    and the loss (SwapAxis for [B,V,T], Reshape for the flat layout)."""
    heads = symbol._heads
    if len(heads) == 1 and not heads[0][0].is_var \
            and heads[0][0].spec.name in _LOSS_HEADS:
        node = heads[0][0].inputs[0][0]
        while not node.is_var \
                and node.spec.name in ("SwapAxis", "Reshape", "Flatten"):
            node = node.inputs[0][0]
        return symbol.get_internals()[node.name + "_output"]
    return symbol


def _dot(a, b):
    """``(a * b).sum(-1)``, broadcast: the f32 products of the blocked
    and ring reads. A batched GEMM picks its algorithm by the batch count,
    so a row's f32 bits would depend on how many rows share the call; an
    elementwise product summed over its last, contiguous axis reduces each
    output in the same order whatever the batch (and on the card, captured
    or not), so the engine's rounds equal ``Decoder.generate``."""
    return (a * b).sum(-1)


def ring_entry(entry):
    """Whether a cache entry is a windowed node's ring: its K/V (and row
    scales), then its positions (:meth:`Decoder.init_cache`), an odd
    count of buffers."""
    return len(entry) % 2 == 1


def rank_trees(caches):
    """The per-rank trees of a cache: a sharded cache
    (:meth:`Decoder.init_cache` with ``kv_sharding``, a list of tp=1
    layout trees) as it is, an unsharded one (a list of per-node tuples)
    as its only rank."""
    return caches if caches and isinstance(caches[0], list) else [caches]


_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``, in two 16-bit halves of ``c`` so that no product
    leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x):
    """lowbias32 (C. Wellons, "Prospecting for hash functions", 2018): a
    bijection of [0, 2**32) whose output bits each flip with probability
    near 1/2 when one input bit flips."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_draw(seed, position):
    """One uniform in (0, 1) per element: a function of the int64
    ``seed`` and ``position`` and of nothing else (the port's counterpart
    of ``jax.random.fold_in(key(seed), position)``). Both halves of the
    seed and then the position are folded through :func:`_hash32`; the
    top 24 bits of the result give the float32 uniform."""
    h = _hash32(seed & _M32)
    h = _hash32(h ^ ((seed >> 32) & _M32))
    h = _hash32(_hash32(h ^ (position & _M32)))
    return ((h >> 8).to(torch.float32) + 0.5) * 2.0 ** -24


def sample_tokens(logits, temperature, u):
    """The next token of each row of ``logits`` [N, V]: the argmax where
    ``temperature`` [N] is 0; elsewhere the token whose interval of the
    cumulative ``softmax(logits / temperature)`` holds ``u`` [N], the
    row's :func:`uniform_draw` of (seed, position) — so a request's
    stream depends on its seed and its positions only, never on what
    else shares the batch. All on the device, with no host read."""
    greedy = torch.argmax(logits, dim=-1)
    t = torch.where(temperature > 0, temperature,
                    torch.ones_like(temperature))
    cdf = torch.cumsum(torch.softmax(logits.to(torch.float32) / t[:, None],
                                     dim=-1), dim=-1)
    drawn = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None].contiguous()
                               )[:, 0]
    drawn = drawn.clamp_max(logits.shape[-1] - 1)
    return torch.where(temperature > 0, drawn, greedy)


class Decoder:
    """Autoregressive KV-cache decoder over a Symbol LM.

    Parameters
    ----------
    symbol : Symbol
        The LM graph, logits-headed or ending in SoftmaxOutput (the loss
        head is stripped).
    params : dict[str, tensor or numpy array]
        Parameter values by name (e.g. a checkpoint's ``arg_params``).
    max_len : int
        Static cache length (within the trained ``pos_embed`` table).
    aux_params : dict, optional
        Auxiliary states of graphs that carry them.
    compute_dtype : str or torch.dtype, optional
        Cast floating parameters (and the cache) for the decode math,
        e.g. ``"bfloat16"``.
    cache_block : int, None or "auto"
        The dense read's blocked form for single-token steps: an online
        softmax over ``cache_block``-row blocks (:meth:`_blocked_attn`).
        Must divide ``max_len``. ``"auto"`` resolves as in the JAX
        package: ``None`` up to ``max_len`` 512 (and for a ``max_len``
        128 does not divide), 128 beyond. With ``attn_impl="paged"``
        ``"auto"`` means ``None`` (the paged read is already bounded by
        each sequence's live rows) and an integer raises.
    cache_dtype : optional
        ``"int8"`` stores K/V quantized with f32 row scales (amax/127 per
        position and head), dequantized at the read; a float dtype stores
        the cache at that dtype; default follows ``compute_dtype``.
    attn_impl : {None, "paged", "dense"}
        The cache read: the paged kernel over each sequence's live rows,
        or the dense masked read (blocked for single tokens where
        ``cache_block`` is set). ``None`` reads
        ``MXNET_SERVING_ATTN_IMPL`` as the JAX package does; unset, it
        means ``"paged"`` here where the JAX package takes ``"dense"``
        (both compute the same attention over a sequence's live rows),
        and ``"dense"`` for an LM with a windowed attention node, as in
        the JAX package. A windowed LM asked for ``"paged"`` warns and
        reads dense (ring rows live at wrapped positions, outside the
        paged read's ``[0, pos]`` rows).
    weight_dtype : {None, "float", "int8", "int4"}
        Weight storage: quantize every matmul weight (attention
        projections, FullyConnected, Embedding, the MoE gate and expert
        stacks) with per-output-channel
        (int8) or per-group (int4) f32 scales, dequantized on the fly.
        ``None`` reads ``MXNET_SERVING_WEIGHT_DTYPE``, else ``"float"``,
        as the JAX package does.
    weight_group : int, optional
        int4 group width (default: the largest of 128..2 dividing E).
    matmul_impl : {None, "dense", "pallas", "fused"}
        Quantized products: ``"dense"`` the plain chunked product,
        ``"pallas"`` the ``quant_matmul`` kernel, ``"fused"`` the kernel
        plus the one-launch ``fused_decode_attention`` step where
        eligible (the name is the JAX package's, so one configuration
        reads the same in both). ``None`` reads
        ``MXNET_SERVING_MATMUL_IMPL``, else ``"dense"``, as the JAX
        package does.
    device : optional, keyword-only (the port's own)
        Where parameters and caches live; ``None`` means ``cuda:0`` and
        raises without CUDA. Pass ``"cpu"`` to run the plain versions on
        the host.
    """

    def __init__(self, symbol, params, max_len, aux_params=None,
                 compute_dtype=None, cache_block="auto", cache_dtype=None,
                 attn_impl=None, weight_dtype=None, weight_group=None,
                 matmul_impl=None, *, device=None):
        if attn_impl is None:
            attn_impl = os.environ.get("MXNET_SERVING_ATTN_IMPL") or None
        if attn_impl not in (None, "dense", "paged"):
            raise MXNetError(
                "Decoder: attn_impl must be 'dense' or 'paged', got %r "
                "(MXNET_SERVING_ATTN_IMPL sets the default)" % (attn_impl,))
        if weight_dtype is None:
            weight_dtype = os.environ.get(
                "MXNET_SERVING_WEIGHT_DTYPE") or "float"
        if matmul_impl is None:
            matmul_impl = os.environ.get(
                "MXNET_SERVING_MATMUL_IMPL") or "dense"
        self.device = resolve_device(device)
        symbol = _logits_symbol(symbol)
        self._topo = symbol._topo()
        self._heads = symbol._heads
        if len(self._heads) != 1:
            raise MXNetError("Decoder needs a single-output symbol, got %d"
                             % len(self._heads))
        self.max_len = int(max_len)
        if matmul_impl not in ("dense", "pallas", "fused"):
            raise MXNetError(
                "Decoder: matmul_impl must be 'dense', 'pallas' or "
                "'fused', got %r" % (matmul_impl,))
        self._matmul_impl = matmul_impl
        if weight_dtype not in ("float", "int8", "int4"):
            raise MXNetError(
                "Decoder: weight_dtype must be 'float', 'int8' or "
                "'int4', got %r" % (weight_dtype,))
        self.weight_dtype = weight_dtype
        self.weight_group = weight_group
        self._bias32 = {}

        self._mha = []
        for n in self._topo:
            if n.is_var:
                continue
            name = n.spec.name
            if name == "MultiHeadAttention":
                if not n.params["causal"]:
                    raise MXNetError(
                        "Decoder: attention node %r is non-causal — "
                        "autoregressive decoding is defined only for "
                        "causal attention" % n.name)
                self._mha.append(n)
            elif name not in _TEMPORAL and name not in _POSITIONWISE:
                raise MXNetError(
                    "Decoder: op %s (node %r) is not known to be "
                    "position-wise; the decode transform supports the "
                    "standard LM ops (%s)"
                    % (name, n.name, ", ".join(sorted(_POSITIONWISE))))
        windowed = any(self._node_window(n) for n in self._mha)
        asked_paged = attn_impl == "paged"
        if attn_impl is None:
            # the port's default: the paged read, except where a windowed
            # node needs the ring read (the JAX package's default there)
            attn_impl = "dense" if windowed else "paged"
        self._attn_impl = attn_impl
        # the JAX package's cache_block resolution (its l.186-207)
        if attn_impl == "paged":
            if cache_block == "auto":
                cache_block = None
            elif cache_block is not None:
                raise MXNetError(
                    "Decoder: attn_impl='paged' and cache_block are two "
                    "prefix-bounded read strategies — pass "
                    "cache_block=None with the paged kernel")
        if cache_block == "auto":
            cache_block = None if self.max_len <= 512 else 128
            if cache_block is not None and self.max_len % cache_block:
                cache_block = None
        self._cache_block = None if cache_block is None else int(cache_block)
        if self._cache_block is not None and (
                self._cache_block < 1
                or self.max_len % self._cache_block != 0):
            raise MXNetError(
                "Decoder: cache_block=%r must be a positive divisor of "
                "max_len=%d" % (cache_block, self.max_len))
        if asked_paged and windowed:
            warnings.warn(
                "Decoder: attn_impl='paged' does not compose with "
                "windowed ring caches (ring rows live at wrapped "
                "positions, not a [0, pos) prefix) — serving with the "
                "exact dense ring walk instead", UserWarning,
                stacklevel=2)
            self._attn_impl = "dense"

        arg_names = [n.name for n in self._topo if n.is_var]
        self._data_name = "data" if "data" in arg_names else arg_names[0]
        missing = [a for a in arg_names
                   if a != self._data_name and a not in params]
        if missing:
            raise MXNetError("Decoder: missing parameter values for %s"
                             % missing)
        cdt = None if compute_dtype is None else torch_dtype(compute_dtype)

        def place(v):
            t = _tensor_of(v).detach().to(self.device)
            return t.to(cdt) if cdt is not None and t.is_floating_point() \
                else t

        self._params = {a: place(params[a]) for a in arg_names
                        if a != self._data_name}
        aux_names = symbol.list_auxiliary_states()
        missing_aux = [a for a in aux_names if a not in (aux_params or {})]
        if missing_aux:
            raise MXNetError("Decoder: missing aux_params values for %s"
                             % missing_aux)
        self._aux = [place(aux_params[a]) for a in aux_names]
        if cache_dtype is None:
            self._cache_int8 = False
            self._cache_dtype = cdt or torch.float32
        else:
            self._cache_dtype = torch_dtype(cache_dtype)
            self._cache_int8 = self._cache_dtype == torch.int8
            if not self._cache_int8 \
                    and not self._cache_dtype.is_floating_point:
                raise MXNetError(
                    "Decoder: cache_dtype must be 'int8' or a float "
                    "dtype, got %r" % (cache_dtype,))

        for n in self._topo:
            if not n.is_var and n.spec.name == "PositionalEmbedding":
                pos_param = n.inputs[1][0].name
                rows = self._params[pos_param].shape[0]
                if rows < self.max_len:
                    raise MXNetError(
                        "Decoder: max_len=%d exceeds the %d trained "
                        "positions of %r" % (self.max_len, rows,
                                             pos_param))

        if weight_dtype in ("int8", "int4"):
            bits = 8 if weight_dtype == "int8" else 4
            if bits == 4 and self._mha:
                wname = self._mha[0].inputs[1][0].name
                self.weight_group = resolve_group(
                    self._params[wname].shape[-1], weight_group)
            self._params = quantize_params(
                self._params, quantized_weight_names(self._topo),
                bits=bits, group=weight_group,
                row_quant=self._embedding_weight_names())

    @classmethod
    def from_checkpoint(cls, prefix, epoch, max_len, **kwargs):
        """Build a decoder from ``prefix-symbol.json`` +
        ``prefix-NNNN.params`` (either package's checkpoints)."""
        from ..model import load_checkpoint

        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return cls(symbol, arg_params, max_len, aux_params=aux_params,
                   **kwargs)

    def _embedding_weight_names(self):
        """Parameter names consumed as Embedding tables (always per-row
        int8 under quantization: they are gathered by rows)."""
        return {n.inputs[1][0].name for n in self._topo
                if not n.is_var and n.spec.name == "Embedding"}

    def _node_window(self, node):
        """Ring rows of a windowed attention node (0 for an ordinary,
        full-history node)."""
        w = node.params.get("window", 0)
        return min(int(w), self.max_len) if w else 0

    # -- cache ----------------------------------------------------------
    def init_cache(self, batch_size, kv_sharding=None):
        """Zeroed K/V buffers, ``[B, max_len, Hkv, D]`` per attention
        node (plus ``[B, max_len, Hkv]`` f32 row scales for an int8
        cache). A windowed node gets a RING of ``window`` rows instead,
        ``[B, window, Hkv, D]`` (and its scales), followed by a ``[B,
        window]`` int32 buffer of each row's absolute position (-1: never
        written), the entry's last buffer.

        ``kv_sharding`` (a :class:`~.shard.NamedSharding` whose spec names
        the kv-head dimension, ``NamedSharding(mesh, P(None, None,
        "model"))``): the cache sharded over that mesh axis, as a list
        with one tree a rank, in rank order. Each is the tp=1 layout with
        ``Hkv/tp`` heads (the rank's contiguous block, as
        :meth:`cache_specs` says) and a whole copy of each ring's
        positions, every buffer its own contiguous allocation on the
        rank's device: the layout the walk's ``tp=`` reads."""
        if kv_sharding is None:
            return self._cache_tree(batch_size, self.device)
        if not isinstance(kv_sharding, NamedSharding):
            raise MXNetError(
                "Decoder.init_cache: kv_sharding must be a parallel."
                "NamedSharding, got %r" % type(kv_sharding).__name__)
        axis = kv_sharding.spec[2] if len(kv_sharding.spec) > 2 else None
        if axis is None:
            raise MXNetError(
                "Decoder.init_cache: kv_sharding must name the kv-head "
                "dimension (spec P(None, None, axis)), got %r"
                % (kv_sharding.spec,))
        ranks = kv_sharding.mesh.axis_devices(axis)
        caches = self._cache_tree(batch_size, torch.device("meta"))
        specs = self.cache_specs(caches, axis)
        out = []
        for dev in ranks:
            tree = []
            for entry, espec in zip(caches, specs):
                bufs = []
                for buf, spec in zip(entry, espec):
                    shape = list(buf.shape)
                    if spec == PartitionSpec(None, None, axis):
                        if shape[2] % len(ranks):
                            raise MXNetError(
                                "Decoder.init_cache: %d kv heads do not "
                                "divide evenly over %d shards"
                                % (shape[2], len(ranks)))
                        shape[2] //= len(ranks)
                    bufs.append(torch.full(shape, CACHE_FILL[buf.dim()],
                                           dtype=buf.dtype, device=dev))
                tree.append(tuple(bufs))
            out.append(tree)
        return out

    def _cache_tree(self, batch_size, device):
        """One unsharded cache tree on ``device``."""
        caches = []
        for n in self._mha:
            w = self._params[n.inputs[1][0].name]
            e = w.shape[-1] if isinstance(w, QuantizedTensor) \
                else w.shape[1]
            h = n.params["num_heads"]
            win = self._node_window(n)
            shape = (batch_size, win or self.max_len,
                     _MHA.kv_heads(n.params), e // h)
            kw = dict(device=device)
            if self._cache_int8:
                entry = (torch.zeros(shape, dtype=torch.int8, **kw),
                         torch.ones(shape[:3], dtype=torch.float32, **kw),
                         torch.zeros(shape, dtype=torch.int8, **kw),
                         torch.ones(shape[:3], dtype=torch.float32, **kw))
            else:
                entry = (torch.zeros(shape, dtype=self._cache_dtype, **kw),
                         torch.zeros(shape, dtype=self._cache_dtype, **kw))
            if win:
                entry += (torch.full(shape[:2], -1, dtype=torch.int32,
                                     **kw),)
            caches.append(entry)
        return caches

    @staticmethod
    def cache_specs(caches, axis="model"):
        """The :class:`~.shard.PartitionSpec` of each buffer of an
        unsharded cache tree: K/V and row-scale buffers (rank 3 or more)
        shard their kv-head dimension (dim 2) over ``axis``, and the ring
        positions (rank 2, no head dimension) replicate. :meth:`init_cache`
        lays a sharded cache out by it."""
        return [tuple(PartitionSpec(None, None, axis) if b.dim() >= 3
                      else PartitionSpec() for b in entry)
                for entry in caches]

    @staticmethod
    def _quantize_rows(x):
        """[B, C, H, D] float -> (int8 values, [B, C, H] f32 scales):
        symmetric amax/127 per (position, head) row."""
        xf = x.to(torch.float32)
        s = xf.abs().amax(dim=-1) / 127.0
        s = torch.where(s > 0, s, torch.ones_like(s))
        return torch.round(xf / s[..., None]).to(torch.int8), s

    def _cache_rows(self, k, v):
        """A [B, C, Hkv, D] K/V chunk as the cache stores it, one tensor a
        cache buffer: int8 values and their [B, C, Hkv] f32 row scales (K,
        then V) for an int8 cache, else K and V in the cache dtype. Each
        head's rows depend on that head alone."""
        if self._cache_int8:
            return self._quantize_rows(k) + self._quantize_rows(v)
        return k.to(self._cache_dtype), v.to(self._cache_dtype)

    @staticmethod
    def _write_cache(entry, rows, ctx):
        """Write :meth:`_cache_rows` ``rows`` into rows ``[pos, pos+C)``
        of each batch row of ``entry``, in place (the rows come from the
        run's ``ctx``)."""
        sidx, at = ctx["sidx"], ctx["rows"]
        for buf, val in zip(entry, rows):
            buf[sidx, at] = val
        return entry

    # -- the derived incremental walk -----------------------------------
    def _qmm(self, x, qt, impl):
        """One quantized matmul ``x [..., E] @ qt [F, E]^T`` under
        ``impl``: the plain chunked product for ``"dense"``, the
        ``quant_matmul`` kernel otherwise."""
        if impl == "dense":
            return scale_fused_matmul(x, qt)
        f = qt.q.shape[0]
        out = kernels.quant_matmul(x.reshape(-1, x.shape[-1]), qt.q,
                                   qt.scale, bits=qt.bits, group=qt.group,
                                   out_dtype=x.dtype)
        return out.reshape(tuple(x.shape[:-1]) + (f,))

    def _f32(self, t):
        """``t`` in f32, converted once per parameter tensor (the fused
        kernel takes its biases in f32 whatever the compute dtype)."""
        hit = self._bias32.get(id(t))
        if hit is None or hit[0] is not t:
            hit = self._bias32[id(t)] = (t, t.to(torch.float32).contiguous())
        return hit[1]

    def _fused_decode_mha(self, node, ins, entry, ctx):
        """The one-launch decode chain (``matmul_impl="fused"``): QKV
        projection -> rope -> attention over the live rows and the new
        token -> output projection; the new k/v rows are written after
        the kernel, which reads the same as writing first."""
        x, wqkv, bqkv, wo, bo = ins
        b, _, e = x.shape
        out, kn, vn = kernels.fused_decode_attention(
            x.reshape(b, e), ctx["pos"], entry[0], entry[1],
            wqkv.q, wqkv.scale, self._f32(bqkv), wo.q, wo.scale,
            self._f32(bo),
            heads=node.params["num_heads"],
            kv_heads=_MHA.kv_heads(node.params), bits=wqkv.bits,
            group=wqkv.group, rope=bool(node.params.get("rope")),
            rope_base=float(node.params.get("rope_base") or 10000.0))
        entry = self._write_cache(
            entry, self._cache_rows(kn[:, None], vn[:, None]), ctx)
        return out.reshape(b, 1, e), entry

    def _paged_read(self, q, entry, ctx):
        """The paged kernel's read of cache ``entry`` for the chunk's
        queries ``q`` [B, C, H, D] (the rows are written already)."""
        if self._cache_int8:
            ck, ks, cv, vs = entry
            return kernels.paged_attention(q.contiguous(), ck, cv,
                                           ctx["pos"], k_scale=ks,
                                           v_scale=vs)
        ck, cv = entry
        return kernels.paged_attention(q.contiguous(), ck, cv, ctx["pos"])

    def _read_cache(self, entry, dtype, limit=None):
        """The cache's K/V for the dense read: an int8 cache dequantized
        in f32 (values times their row scales) and cast to ``dtype``, a
        float cache at its stored dtype. ``limit``: only rows ``[0,
        limit)``."""
        if self._cache_int8:
            ck, ks, cv, vs = entry[:4]
            if limit is not None and limit < ck.shape[1]:
                ck, ks, cv, vs = (t[:, :limit] for t in (ck, ks, cv, vs))
            return ((ck.to(torch.float32) * ks[..., None]).to(dtype),
                    (cv.to(torch.float32) * vs[..., None]).to(dtype))
        ck, cv = entry[:2]
        if limit is not None and limit < ck.shape[1]:
            ck, cv = ck[:, :limit], cv[:, :limit]
        return ck, cv

    def _dense_attn(self, q, entry, ctx):
        """The dense read (the JAX package's l.676-706): every query row
        against all ``max_len`` cache rows under the mask ``key_pos <=
        query_pos``, each row at its own positions (``ctx["rows"]``). The
        scores, the ``-1e30`` mask and the softmax are in q's dtype (a
        float cache of another dtype promotes, as in the JAX package);
        grouped query heads fold to ``[B, C, Hkv, G, D]`` against their
        shared kv head, so the cache is never repeated. The JAX package
        clamps an offline call's read to ``pos + C`` rows; here every
        call reads ``max_len`` rows (a staging cache's rows past them hold
        keys no real query sees), so that a prefill, a decode step and
        the engine's programs read alike. Returns o [B, C, H, D] in q's
        dtype."""
        b, c, h, d = q.shape
        ck, cv = self._read_cache(entry, q.dtype, limit=self.max_len)
        dt = torch.promote_types(q.dtype, ck.dtype)
        qd, ck, cv = q.to(dt), ck.to(dt), cv.to(dt)
        kv = ck.shape[2]
        kpos = torch.arange(ck.shape[1], device=q.device)
        ok = kpos <= ctx["rows"][:, :, None]                  # [B, C, L]
        if kv == h:
            s = torch.einsum("bqhd,bkhd->bhqk", qd, ck) / math.sqrt(d)
            s = torch.where(ok[:, None], s, -1e30)
            o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                             cv)
        else:
            qg = qd.reshape(b, c, kv, h // kv, d)
            s = torch.einsum("bqKgd,bkKd->bKgqk", qg, ck) / math.sqrt(d)
            s = torch.where(ok[:, None, None], s, -1e30)
            o = torch.einsum("bKgqk,bkKd->bqKgd", torch.softmax(s, dim=-1),
                             cv).reshape(b, c, h, d)
        return o.to(q.dtype)

    def _block_update(self, q, kb, vb, start, pos, carry):
        """One block of :meth:`_blocked_attn`: the f32 query ``q`` [B, 1,
        H, D] against the f32 cache rows ``kb``/``vb`` [B, bl, Hkv, D] at
        positions ``[start, start + bl)``, keys past each row's ``pos``
        [B] masked, folded into the running ``(max, sum, acc)``. A block
        wholly past a row's ``pos`` leaves its carry bit for bit as it
        was: ``alpha = exp(m - m) = 1`` and ``p = 0``. The two products
        are elementwise products summed over their last axis
        (:func:`_dot`), so that a row's bits do not depend on the batch."""
        m, s, acc = carry
        b, c, h, d = q.shape
        bl, kvh = kb.shape[1], kb.shape[2]
        g = h // kvh
        qg = q.reshape(b, kvh, g, d)                        # c == 1
        sc = _dot(qg[:, :, :, None], kb.permute(0, 2, 1, 3)[:, :, None]) \
            .reshape(b, h, c, bl) / math.sqrt(d)
        kpos = start + torch.arange(bl, device=q.device)
        sc = torch.where(kpos <= pos.long()[:, None, None, None], sc,
                         -math.inf)
        m2 = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m2)
        p = torch.exp(sc - m2[..., None])
        s2 = s * alpha + p.sum(dim=-1)
        upd = _dot(p.reshape(b, kvh, g, 1, bl),
                   vb.permute(0, 2, 3, 1)[:, :, None]).reshape(b, h, c, d)
        return m2, s2, acc * alpha[..., None] + upd

    def _cache_block_rows(self, entry, start):
        """Rows ``[start, start + cache_block)`` of the cache's K and V in
        f32 (an int8 cache times its row scales)."""
        sl = slice(start, start + self._cache_block)
        if self._cache_int8:
            ck, ks, cv, vs = entry[:4]
            return (ck[:, sl].to(torch.float32) * ks[:, sl, :, None],
                    cv[:, sl].to(torch.float32) * vs[:, sl, :, None])
        return (entry[0][:, sl].to(torch.float32),
                entry[1][:, sl].to(torch.float32))

    def _blocked_attn(self, q, entry, pos):
        """The single-token read in ``cache_block``-row blocks (the JAX
        package's l.822-886): an online softmax in f32 over the blocks,
        each row masked by its own ``pos`` [B]. The JAX package stops at
        the ``ceil((pos + 1) / cache_block)`` live blocks (a traced trip
        count); a CUDA graph has a fixed one, so this loop runs over every
        block of ``max_len``, and the blocks past a row's position change
        nothing (:meth:`_block_update`). Returns o [B, 1, H, D] in q's
        dtype."""
        b, c, h, d = q.shape
        qf = q.to(torch.float32)
        m = torch.full((b, h, c), -math.inf, dtype=torch.float32,
                       device=q.device)
        s = torch.zeros((b, h, c), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, c, d), dtype=torch.float32,
                          device=q.device)
        carry = (m, s, acc)
        for start in range(0, self.max_len, self._cache_block):
            kb, vb = self._cache_block_rows(entry, start)
            carry = self._block_update(qf, kb, vb, start, pos, carry)
        _, s, acc = carry
        o = (acc / s[..., None]).to(q.dtype)
        return o.transpose(1, 2)

    def _window_attn(self, q, k, v, entry, pos, win, valid_len=None):
        """Sliding-window attention against a ring cache (the JAX
        package's l.718-820), each row at its own ``pos`` [B].

        Query ``i`` (absolute position ``a = pos + i``) sees the ``win``
        keys at positions ``a - win + 1 .. a``: those at or past ``pos``
        from the chunk itself, the earlier ones from the ring as it was
        before this chunk, where a ring row is visible iff it holds that
        very position (never written, wiped, or since overwritten: not).
        That is the JAX package's visible set (its ring and chunk masks);
        here each query's keys are gathered in position order into a
        fixed ``[win]`` row, and one f32 softmax runs over it, so a
        query's arithmetic does not depend on how its prompt was cut into
        pieces, on the pad rows after it, or on the other rows of the
        batch. The ring is read before it is written, so a chunk longer
        than the window reads what it needs first. Returns o [B, C, H, D]
        in q's dtype; the ring and its positions are written in place.

        The write: the last ``min(win, valid)`` VALID rows of the chunk,
        where row ``i`` is valid iff ``pos + i < valid_len`` (``None``:
        every row). A right-padded prefill piece must not let its pad rows
        into the ring (a ring row wraps, so a pad key would evict a real
        one). The JAX package drops the other rows' writes with
        ``mode="drop"``; here the write is a fixed ``[B, win]`` index
        (static, as a graph needs): the ``win`` consecutive positions
        ending at the chunk's last valid row fill each ring row once, and
        a row whose chunk row is invalid is written its own old value."""
        b, c, h, d = q.shape
        kvh = k.shape[2]
        g = h // kvh
        ring = entry[:-1]
        cpos = entry[-1]
        if self._cache_int8:
            ck, ks, cv, vs = ring
            ckf = ck.to(torch.float32) * ks[..., None]
            cvf = cv.to(torch.float32) * vs[..., None]
        else:
            ckf, cvf = (t.to(torch.float32) for t in ring)
        p64 = pos.long()
        dev = q.device
        # key t of query i sits at absolute position a - win + 1 + t
        kp = (p64[:, None, None] + torch.arange(c, device=dev)[:, None]
              - win + 1 + torch.arange(win, device=dev))      # [B, C, win]
        in_chunk = kp >= p64[:, None, None]
        slot = kp % win
        src = torch.where(in_chunk, win + (kp - p64[:, None, None]), slot)
        ok = in_chunk | ((kp >= 0) & (cpos.long().gather(
            1, slot.reshape(b, -1)).reshape(b, c, win) == kp))
        flat = src.reshape(b, c * win, 1, 1).expand(b, c * win, kvh, d)
        keys = torch.cat([ckf, k.to(torch.float32)], 1).gather(1, flat) \
            .reshape(b, c, win, kvh, d)
        vals = torch.cat([cvf, v.to(torch.float32)], 1).gather(1, flat) \
            .reshape(b, c, win, kvh, d)
        qg = q.to(torch.float32).reshape(b, c, kvh, g, d)
        s = _dot(qg[:, :, :, :, None], keys.permute(0, 1, 3, 2, 4)[
            :, :, :, None]) / math.sqrt(d)                  # [B, C, K, g, win]
        s = torch.where(ok[:, :, None, None], s, -math.inf)
        o = _dot(torch.softmax(s, dim=-1)[:, :, :, :, None],
                 vals.permute(0, 1, 3, 4, 2)[:, :, :, None]) \
            .reshape(b, c, h, d).to(q.dtype)

        if valid_len is None:
            vc = torch.full_like(p64, c)
        else:
            vc = (torch.as_tensor(valid_len, device=dev).long()
                  - p64).clamp(0, c)
        idx = vc[:, None] - win + torch.arange(win, device=dev)
        valid = idx >= 0                                       # [B, win]
        gidx = idx.clamp(0, c - 1)
        slots = (p64[:, None] + idx) % win      # each ring row once
        newpos = (p64[:, None] + gidx).to(torch.int32)
        take = gidx[:, :, None, None].expand(b, win, kvh, d)
        rows = self._cache_rows(k.gather(1, take), v.gather(1, take))
        bidx = torch.arange(b, device=dev)[:, None]
        for buf, val in zip(ring, rows):
            keep = valid.reshape(valid.shape + (1,) * (val.dim() - 2))
            buf[bidx, slots] = torch.where(keep, val, buf[bidx, slots])
        cpos[bidx, slots] = torch.where(valid, newpos, cpos[bidx, slots])
        return o, entry

    def _attend(self, q, k, v, entry, ctx, win):
        """Write one node's K/V rows into ``entry`` and read it, by the
        JAX package's dispatch (its l.644-707): a windowed node's ring,
        then the paged kernel (``ctx["impl"]``), then the blocked read (a
        single token, ``cache_block`` set), then the dense read. Returns
        (o [B, C, H, D], entry)."""
        if win:
            return self._window_attn(q, k, v, entry, ctx["pos"], win,
                                     ctx.get("valid_len"))
        entry = self._write_cache(entry, self._cache_rows(k, v), ctx)
        if ctx["impl"] == "paged":
            return self._paged_read(q, entry, ctx), entry
        if self._cache_block is not None and q.shape[1] == 1:
            return self._blocked_attn(q, entry, ctx["pos"]), entry
        return self._dense_attn(q, entry, ctx), entry

    @staticmethod
    def _ctx_on(ctx, device):
        """``ctx`` with its tensors on ``device`` (made once a run)."""
        if ctx["pos"].device == device:
            return ctx
        hit = ctx.setdefault("_on", {}).get(device)
        if hit is None:
            hit = ctx["_on"][device] = {
                k: v.to(device) if isinstance(v, torch.Tensor) else v
                for k, v in ctx.items() if k != "_on"}
        return hit

    def _sharded_attention(self, q, k, v, entries, ctx, tp, win):
        """The tensor-parallel attention of one node: rank ``r`` takes
        its contiguous block of ``Hkv/tp`` kv heads and of ``H/tp`` query
        heads (query heads are kv-major, so a GQA group stays whole),
        writes its K/V rows into its own cache shard ``entries[r]`` and
        reads that shard through :meth:`_attend`, the read of tp=1; one
        tiled all-gather on the head axis puts the ranks' outputs back in
        tp=1's head order. Returns o [B, C, H, D] on rank 0's device."""
        ntp = tp[1]
        if len(entries) != ntp:
            raise MXNetError(
                "Decoder: tp=%r over a cache of %d shards"
                % (tuple(tp), len(entries)))
        h, kv = q.shape[2], k.shape[2]
        hl, kvl = h // ntp, kv // ntp
        outs = []
        for r, entry in enumerate(entries):
            dev = entry[0].device
            hs, ks = slice(r * hl, (r + 1) * hl), slice(r * kvl,
                                                        (r + 1) * kvl)
            o, _ = self._attend(q[:, :, hs].to(dev), k[:, :, ks].to(dev),
                                v[:, :, ks].to(dev), entry,
                                self._ctx_on(ctx, dev), win)
            outs.append(o)
        return all_gather(outs, axis=2, tiled=True)[0]

    def _cached_mha(self, node, ins, entry, ctx, mm_impl, tp=None):
        x, wqkv, bqkv, wo, bo = ins
        b, c, e = x.shape
        h = node.params["num_heads"]
        d = e // h
        kv = _MHA.kv_heads(node.params)
        win = self._node_window(node)
        # the JAX package's eligibility rule (decode.py l.587-595)
        if (mm_impl == "fused" and c == 1 and tp is None and len(entry) == 2
                and not win
                and isinstance(wqkv, QuantizedTensor)
                and isinstance(wo, QuantizedTensor)
                and wqkv.bits == wo.bits and wqkv.group == wo.group
                and ctx["impl"] == "paged"):
            return self._fused_decode_mha(node, ins, entry, ctx)
        if isinstance(wqkv, QuantizedTensor):
            qkv = self._qmm(x, wqkv, mm_impl) + bqkv
        else:
            qkv = torch.matmul(x, wqkv.t()) + bqkv
        q = qkv[..., :e].reshape(b, c, h, d)
        k = qkv[..., e:e + kv * d].reshape(b, c, kv, d)
        v = qkv[..., e + kv * d:].reshape(b, c, kv, d)
        if node.params.get("rope"):
            q = rope_rotate(q, ctx["rows"], node.params["rope_base"])
            k = rope_rotate(k, ctx["rows"], node.params["rope_base"])
        if tp is not None:
            # everything up to here ran once at tp=1's shapes; the
            # per-head work runs per rank on its shard
            o = self._sharded_attention(q, k, v, entry, ctx, tp, win)
        else:
            o, entry = self._attend(q, k, v, entry, ctx, win)
        o = o.reshape(b, c, e)
        if isinstance(wo, QuantizedTensor):
            return self._qmm(o, wo, mm_impl) + bo, entry
        return torch.matmul(o, wo.t()) + bo, entry

    def _run(self, params, aux, caches, pos, tokens, valid_len=None,
             tp=None, mm_impl=None, ep=None):
        """One chunk: tokens [B, C] at positions ``[pos, pos+C)`` ->
        (logits [B, C, V], caches), read by the decoder's ``attn_impl``.
        ``pos`` is an int (every row at the same position) or an int32
        tensor [B] (each row at its own); the caches are written in place
        and returned. ``valid_len`` (absolute, an int or a tensor [B])
        marks a right-padded chunk's true end: only the ring writes of
        windowed nodes honour it (a linear cache's pad rows sit at
        positions every read masks until they are overwritten).

        ``tp`` (``(axis_name, degree)``, optional): ``caches`` is sharded
        over ``degree`` ranks (:meth:`init_cache` with ``kv_sharding``);
        every op but the per-head attention runs once, on the device of
        the inputs, at tp=1's shapes, so the logits do not depend on the
        degree.

        ``ep`` (``(axis_name, degree)``, optional): every input of a MoE
        node but its data is a list of ``degree`` rank shards on the
        expert axis, each with its ``X/degree`` experts (the serving
        engine's placement), and the node runs expert-parallel
        (:func:`~mxnet_tpu_torch.serving.quant.moe_ffn_forward`). A MoE
        node also runs that forward when any of its weights is quantized,
        its products through the ``quant_matmul`` kernel unless
        ``mm_impl`` is ``"dense"``; otherwise it runs the op's own
        forward."""
        return self._walk(params, aux, caches, pos, tokens, valid_len, tp,
                          mm_impl, self._attn_impl, ep)

    def _walk(self, params, aux, caches, pos, tokens, valid_len, tp,
              mm_impl, impl, ep=None):
        """:meth:`_run` with the attention read ``impl`` given."""
        if mm_impl is None:
            mm_impl = self._matmul_impl
        qmm = None if mm_impl == "dense" \
            else (lambda x, qt: self._qmm(x, qt, mm_impl))
        b, c = tokens.shape
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((b,), int(pos), dtype=torch.int32,
                             device=self.device)
        # what every attention and positional node of this chunk shares:
        # each row's positions [pos, pos+C), its batch index, the read
        ctx = {"pos": pos,
               "rows": pos.long()[:, None]
               + torch.arange(c, device=pos.device),
               "sidx": torch.arange(b, device=pos.device)[:, None],
               "impl": impl}
        if valid_len is not None:
            ctx["valid_len"] = torch.as_tensor(valid_len,
                                               device=pos.device)
        env = {}
        mha_i = 0
        aux_cursor = 0
        for n in self._topo:
            if n.is_var:
                env[(id(n), 0)] = tokens if n.name == self._data_name \
                    else params[n.name]
                continue
            ins = [env[(id(inp), idx)] for inp, idx in n.inputs]
            name = n.spec.name
            if name == "MultiHeadAttention":
                if tp is None:
                    env[(id(n), 0)], caches[mha_i] = self._cached_mha(
                        n, ins, caches[mha_i], ctx, mm_impl)
                else:
                    env[(id(n), 0)], _ = self._cached_mha(
                        n, ins, [t[mha_i] for t in caches], ctx, mm_impl,
                        tp)
                mha_i += 1
                continue
            if name == "PositionalEmbedding":
                x, posp = ins
                # rows past the table are pad rows of a chunk that runs
                # off the cache's end (the engine's staging cache is
                # longer than max_len): any row of the table will do
                env[(id(n), 0)] = x + posp[
                    ctx["rows"].clamp_max(posp.shape[0] - 1)]
                continue
            if name == "FullyConnected" \
                    and isinstance(ins[1], QuantizedTensor):
                xin = ins[0]
                if n.params["flatten"]:
                    xin = xin.reshape(xin.shape[0], -1)
                out = self._qmm(xin, ins[1], mm_impl)
                if not n.params["no_bias"]:
                    out = out + ins[2]
                env[(id(n), 0)] = out
                continue
            if name == "Embedding" and isinstance(ins[1], QuantizedTensor):
                env[(id(n), 0)] = embedding_rows(ins[1], ins[0])
                continue
            if name == "MoEFFN" and (ep is not None or any(
                    isinstance(z, QuantizedTensor) for z in ins[1:])):
                env[(id(n), 0)] = moe_ffn_forward(n.params, ins, mm=qmm,
                                                  ep=ep)
                continue
            n_aux = len(n.spec.aux_states(n.params))
            aux_in = aux[aux_cursor:aux_cursor + n_aux]
            aux_cursor += n_aux
            outs, _ = n.spec.forward(n.params, ins, aux_in, False, None)
            for j, o in enumerate(outs):
                env[(id(n), j)] = o
        head, idx = self._heads[0]
        return env[(id(head), idx)], caches

    # -- slot-addressed forms (serving engine) --------------------------
    def _run_slots(self, params, aux, caches, pos, tokens, impl=None,
                   tp=None, mm_impl=None, ep=None):
        """Per-slot ``_run``: ``pos`` [S] int32 positions, ``tokens``
        [S, C] -> (logits [S, C, V], caches): one batched walk in which
        each slot writes and reads at its own clock (``tp``: as in
        :meth:`_run`). ``impl`` (default: the decoder's ``attn_impl``)
        picks the read: ``"paged"`` the paged kernel over each slot's live
        rows; ``"dense"`` each slot's rows masked by its own clock over
        all ``max_len`` rows (or blocks), what the JAX package's ``vmap``
        of one-row walks computes (its l.1043-1055). A windowed node reads
        its ring either way. ``"dense"`` on a decoder built paged raises,
        as in the JAX package. ``ep``: as in :meth:`_run`."""
        if impl is None:
            impl = self._attn_impl
        elif impl == "dense" and self._attn_impl == "paged":
            raise MXNetError(
                "Decoder: impl='dense' requested on a decoder built "
                "with attn_impl='paged' — build the decoder dense "
                "(the engine threads its own attn_impl per dispatch)")
        if impl not in ("dense", "paged"):
            raise MXNetError("Decoder: impl must be 'dense' or 'paged', "
                             "got %r" % (impl,))
        return self._walk(params, aux, caches, pos, tokens, None, tp,
                          mm_impl, impl, ep)

    @staticmethod
    def _slot_index(slot, like):
        """``slot`` (an int or a device operand) as an int64 tensor [1] on
        ``like``'s device."""
        return torch.as_tensor(slot, dtype=torch.int64,
                               device=like.device).reshape(1)

    @staticmethod
    def slot_prefix_rows(caches, slot, length):
        """Read rows ``[0, length)`` of one cache slot as a b=1 cache: the
        read half of the serving engine's prefix copy. ``length`` is
        static (the engine buckets it like a prefill, so one program
        serves every copy of that bucket); ``slot`` is an int or an int
        tensor on the cache's device (a program's operand). Rows past
        the true cached length ride along as junk: in the destination
        they sit at positions the ``key_pos <= pos`` mask hides until
        the suffix prefill overwrites them. Every buffer is read, the
        int8 row scales included. A sharded cache gives sharded rows (one
        tree a rank)."""
        if rank_trees(caches) is caches:
            return [Decoder.slot_prefix_rows(t, slot, length)
                    for t in caches]
        out = []
        for entry in caches:
            idx = Decoder._slot_index(slot, entry[0])
            out.append(tuple(buf[:, :length].index_select(0, idx)
                             for buf in entry))
        return out

    @staticmethod
    def slot_write_prefix_rows(caches, slot, rows):
        """Write a :meth:`slot_prefix_rows` result into rows ``[0, C)`` of
        ``slot``, in place: the write half of the slot-to-slot prefix
        copy (a sharded cache takes sharded rows). Returns ``caches``."""
        if rank_trees(caches) is caches:
            for t, r in zip(caches, rows):
                Decoder.slot_write_prefix_rows(t, slot, r)
            return caches
        for entry, rentry in zip(caches, rows):
            idx = Decoder._slot_index(slot, entry[0])
            for full, r in zip(entry, rentry):
                full[:, :r.shape[1]].index_copy_(0, idx, r.to(full.dtype))
        return caches

    @staticmethod
    def slot_slice(caches, slot):
        """One cache slot (an int or an int tensor on the cache's device)
        as a b=1 cache, a copy: the read half of slot addressing; pair
        with :meth:`slot_update`. A sharded cache gives one tree a rank."""
        if rank_trees(caches) is caches:
            return [Decoder.slot_slice(t, slot) for t in caches]
        return [tuple(buf.index_select(0, Decoder._slot_index(slot, buf))
                      for buf in entry) for entry in caches]

    @staticmethod
    def slot_update(caches, slot, sub):
        """Write a b=1 cache (:meth:`slot_slice`'s form) back into
        ``slot`` of the full cache, in place: the write half of slot
        addressing. Returns ``caches``."""
        if rank_trees(caches) is caches:
            for t, st in zip(caches, sub):
                Decoder.slot_update(t, slot, st)
            return caches
        for entry, sentry in zip(caches, sub):
            for full, one in zip(entry, sentry):
                full.index_copy_(0, Decoder._slot_index(slot, full),
                                 one.to(full.dtype))
        return caches

    def clear_window_positions(self, caches, only_if=None):
        """Reset the ring positions of the windowed nodes to -1 (never
        written), in place, and return ``caches``. A reused slot needs
        it: its linear rows stay hidden by the ``key_pos <= pos`` mask
        until they are overwritten, but ring rows are visible by their
        STORED positions, so the last occupant's would leak into the new
        request's window. Nothing to do without windowed nodes.

        ``only_if`` (a bool tensor on the device, optional): reset only
        where it holds, by ``torch.where``, so that a captured program can
        take it as an operand (the serving engine's prefill wipes the ring
        on a request's first piece, ``start == 0``, and keeps it on the
        later ones)."""
        for tree in rank_trees(caches):
            for n, entry in zip(self._mha, tree):
                if not self._node_window(n):
                    continue
                cpos = entry[-1]
                if only_if is None:
                    cpos.fill_(-1)
                else:
                    cond = torch.as_tensor(only_if, device=cpos.device)
                    cpos.copy_(torch.where(cond, torch.full_like(cpos, -1),
                                           cpos))
        return caches

    def verify_step_slots(self, params, aux, caches, state, drafts, dlen,
                          impl=None, tp=None, mm_impl=None, ep=None):
        """Speculative draft-and-verify decode step over all S slots (the
        serving engine's verify program).

        ``state`` is the engine's per-slot state ``(pos, tok, live, temp,
        uniform, eos, last)`` in the JAX package's order, with the port's
        ``uniform`` [S, max_len] (each slot's :func:`uniform_draw` at
        every position) where the JAX package has the PRNG keys.
        ``drafts`` [S, K] are proposed continuations of each slot's head
        token ``tok``; ``dlen`` [S] how many of them are real (0: the slot
        rides along and emits exactly its plain-decode token). Returns
        ``(caches, state2, out)`` with ``out`` [K+1, S]: row i is the i-th
        token emitted this step per slot, -1 where none; ``state2`` is new
        tensors, the caches are written in place.

        One chunked run scores all K drafted positions: the chunk ``[tok,
        d_1..d_K]`` is written at positions ``[pos, pos+K]`` and each
        position's logits give the target's OWN choice there — the argmax,
        or for ``temp > 0`` the :func:`sample_tokens` draw at the slot's
        uniform of position ``pos + i + 1``, the draw a plain decode step
        takes there. Token i is emitted iff every earlier emitted token
        matched its draft and was not terminal; the first mismatch emits
        the target's corrected token and stops. Every emitted token is
        therefore the target's own choice at its position: drafts change
        how many arrive per step, never which.

        The rejected positions' rows sit above the slot's new head, where
        every read masks them until a later write covers them. A chunk
        that would run past the cache's end (a slot the engine holds no
        request in; the engine falls back to plain decode while a
        sequence is that near its end) is written ending at the last row
        instead, as the JAX package's clamped update does. ``tp`` and
        ``ep``: as in :meth:`_run`."""
        pos, tok, live, temp, uniform, eos, last = state
        k = drafts.shape[1]
        chunk = torch.cat([tok[:, None].to(torch.int64),
                           drafts.to(torch.int64)], dim=1)
        logits, caches = self._run_slots(
            params, aux, caches, pos.clamp_max(self.max_len - (k + 1)),
            chunk, impl=impl, tp=tp, mm_impl=mm_impl, ep=ep)  # [S, K+1, V]
        s_, c, v = logits.shape
        at = (pos.long()[:, None] + torch.arange(1, c + 1, device=pos.device)
              ).clamp_max(self.max_len - 1)
        nxt = sample_tokens(logits.reshape(s_ * c, v),
                            temp.repeat_interleave(c),
                            uniform.gather(1, at).reshape(-1)).reshape(s_, c)
        emit = live
        outs = []
        e = torch.zeros_like(pos)
        tok2 = tok
        done_any = torch.zeros_like(live)
        for i in range(k + 1):
            tki = nxt[:, i].to(tok.dtype)
            done_i = (tki == eos) | (pos + i + 1 >= last)
            outs.append(torch.where(emit, tki, torch.full_like(tki, -1)))
            e = e + emit.to(e.dtype)
            tok2 = torch.where(emit, tki, tok2)
            done_any = done_any | (emit & done_i)
            if i < k:
                matched = (dlen > i) & (tki == drafts[:, i].to(tki.dtype))
                emit = emit & matched & ~done_i
        state2 = (pos + e, tok2, live & ~done_any, temp, uniform, eos, last)
        return caches, state2, torch.stack(outs)              # [K+1, S]

    def draft_propose_slots(self, params, aux, caches, pos, catchup, clen,
                            k, impl=None, tp=None, mm_impl=None, ep=None):
        """Greedy ``k``-token proposal from a DRAFT model sharing the
        slot-paged layout (the serving engine's draft program,
        ``InferenceEngine(draft="model")``).

        Two phases in one program: (1) catch up — ``catchup`` [S, W] holds
        each slot's real tokens the draft cache has not seen yet (``clen``
        [S] in [1, W] of them valid; pad rows write junk above the head,
        healed by the next catch-up's overwrite), written at positions
        ``[pos, pos+clen)``; (2) propose — from the last valid position's
        logits, k-1 greedy single-token steps. Returns ``(caches, drafts
        [S, k])``. Greedy always: for sampled requests the target's verify
        still gates acceptance against its own draw. Positions that would
        run past the cache's end (slots the engine holds no request in)
        are written ending at the last row, as the JAX package's clamped
        updates do. ``tp`` and ``ep``: as in :meth:`_run`."""
        w = catchup.shape[1]
        pos = pos.clamp_max(self.max_len - w)
        logits, caches = self._run_slots(
            params, aux, caches, pos, catchup.to(torch.int64), impl=impl,
            tp=tp, mm_impl=mm_impl, ep=ep)                      # [S, W, V]
        idx = (clen.long() - 1).clamp(0, w - 1)
        lastlog = logits.gather(
            1, idx[:, None, None].expand(-1, 1, logits.shape[2]))[:, 0]
        t = torch.argmax(lastlog, dim=-1)
        p = pos + clen.to(pos.dtype)
        out = [t]
        for _ in range(k - 1):
            lg, caches = self._run_slots(
                params, aux, caches, p.clamp_max(self.max_len - 1),
                t[:, None], impl=impl, tp=tp, mm_impl=mm_impl, ep=ep)
            t = torch.argmax(lg[:, 0], dim=-1)
            out.append(t)
            p = p + 1
        return caches, torch.stack(out, dim=1)                 # [S, k]

    # -- user API -------------------------------------------------------
    @staticmethod
    def clone_cache(caches):
        """A deep copy of a cache (sharded or not): the way to branch from
        one prefix, since :meth:`prefill` and :meth:`step` write their
        cache in place."""
        if rank_trees(caches) is caches:
            return [Decoder.clone_cache(t) for t in caches]
        return [tuple(buf.clone() for buf in entry) for entry in caches]

    def _tokens(self, tokens):
        t = torch.as_tensor(tokens)
        if t.is_floating_point():
            raise MXNetError("Decoder: token ids must be integers")
        return t.to(device=self.device, dtype=torch.int64)

    def prefill(self, caches, tokens):
        """Process a [B, P] prompt from position 0; returns
        (logits [B, P, V], caches)."""
        tokens = self._tokens(tokens)
        if tokens.shape[1] > self.max_len:
            raise MXNetError("Decoder: prompt length %d exceeds max_len %d"
                             % (tokens.shape[1], self.max_len))
        return self._run(self._params, self._aux, caches, 0, tokens)

    def step(self, caches, pos, token):
        """One token per sequence: token [B] at position ``pos`` ->
        (logits [B, V], caches)."""
        if not 0 <= pos < self.max_len:
            raise MXNetError(
                "Decoder: step position %d outside the cache [0, %d)"
                % (pos, self.max_len))
        logits, caches = self._run(self._params, self._aux, caches, pos,
                                   self._tokens(token)[:, None])
        return logits[:, 0], caches

    def generate(self, prompt, num_steps, rng=None, temperature=0.0,
                 return_cache=False):
        """Greedy (``temperature=0``) or sampled continuation.

        prompt: [B, P] token ids. Returns [B, P + num_steps] int64 —
        the prompt followed by the generated ids — or ``(tokens,
        caches)`` with ``return_cache=True`` (K/V through position
        ``P + num_steps - 1``). Sampled draws come from ``rng``, a
        ``torch.Generator`` on the decoder's device where the JAX
        package takes a PRNG key: the same seed gives the same draws
        (not the JAX package's). ``rng=None`` draws from PyTorch's
        default generator, so repeated calls differ, as they do in the
        JAX package."""
        if rng is not None and not isinstance(rng, torch.Generator):
            raise MXNetError("Decoder.generate: rng must be a "
                             "torch.Generator, got %r" % type(rng).__name__)
        prompt = self._tokens(prompt)
        b, p = prompt.shape
        if p + num_steps > self.max_len:
            raise MXNetError(
                "Decoder: prompt %d + steps %d exceeds max_len %d"
                % (p, num_steps, self.max_len))

        def pick(logits):
            if temperature <= 0.0:
                return torch.argmax(logits, dim=-1)
            probs = torch.softmax(logits.to(torch.float32) / temperature,
                                  dim=-1)
            return torch.multinomial(probs, 1, generator=rng)[:, 0]

        caches = self.init_cache(b)
        logits, caches = self._run(self._params, self._aux, caches, 0,
                                   prompt)
        tok = pick(logits[:, -1])
        toks = []
        for i in range(num_steps):
            toks.append(tok)
            logits, caches = self._run(self._params, self._aux, caches,
                                       p + i, tok[:, None])
            tok = pick(logits[:, 0])
        out = torch.cat([prompt] + [t[:, None] for t in toks], dim=1)
        return (out, caches) if return_cache else out

    def beam_search(self, prompt, num_steps, beam_size, eos_id=None,
                    length_penalty=0.0):
        """Beam-search continuation: the ``beam_size`` highest
        log-probability continuations, kept at every step (the JAX
        package's l.1424-1538, run as an eager loop).

        prompt: [B, P] token ids. Returns ``(sequences, scores)``:
        sequences [B, beam_size, P + num_steps] int64 and scores
        [B, beam_size] f32 (the sum of the tokens' log-probs; with
        ``length_penalty`` > 0 the ranking divides by
        ``length ** length_penalty``), best first per batch row.

        ``eos_id``: a beam that emits it is FINISHED — it stops expanding
        (its later tokens are 0, at no score cost) and keeps competing on
        its final score. The beams are one folded [B*K] batch, and each
        step the cache rows follow their parent beams (one
        ``index_select`` a buffer). A beam wider than the vocabulary is
        padded with dead beams. Ties break as ``lax.top_k`` breaks them,
        the lower index first (a stable descending sort: ``torch.topk``'s
        tie order is unspecified on CUDA, and frozen beams tie at
        ``-1e30`` routinely)."""
        prompt = self._tokens(prompt)
        b, p = prompt.shape
        k = int(beam_size)
        if k < 1:
            raise MXNetError("beam_size must be >= 1, got %d" % k)
        if num_steps < 1:
            raise MXNetError("beam_search needs num_steps >= 1")
        if p + num_steps > self.max_len:
            raise MXNetError(
                "Decoder: prompt %d + steps %d exceeds max_len %d"
                % (p, num_steps, self.max_len))
        neg = -1e30
        dev = prompt.device

        def top_k(x, n):
            vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
            return vals[..., :n], idx[..., :n]

        logits, caches = self._run(self._params, self._aux,
                                   self.init_cache(b), 0, prompt)
        logp0 = torch.log_softmax(logits[:, -1].to(torch.float32), dim=-1)
        v = logp0.shape[-1]
        kk = min(k, v)
        scores, tok = top_k(logp0, kk)                        # [B, kk]
        if kk < k:
            scores = torch.cat([scores, torch.full((b, k - kk), neg,
                                                   device=dev)], 1)
            tok = torch.cat([tok, torch.zeros((b, k - kk), dtype=tok.dtype,
                                              device=dev)], 1)
        caches = [tuple(buf.repeat_interleave(k, dim=0) for buf in entry)
                  for entry in caches]
        seqs = torch.zeros((b, k, p + num_steps), dtype=torch.int64,
                           device=dev)
        seqs[:, :, :p] = prompt[:, None, :]
        seqs[:, :, p] = tok
        finished = tok == eos_id if eos_id is not None \
            else torch.zeros((b, k), dtype=torch.bool, device=dev)
        lengths = torch.ones((b, k), dtype=torch.float32, device=dev)
        frozen = torch.full((v,), neg, device=dev)
        frozen[0] = 0.0
        base = torch.arange(b, device=dev)[:, None] * k
        for i in range(num_steps - 1):
            logits, caches = self._run(self._params, self._aux, caches,
                                       p + i, tok.reshape(b * k)[:, None])
            logp = torch.log_softmax(logits[:, 0].to(torch.float32),
                                     dim=-1).reshape(b, k, v)
            # a finished beam may only 'emit' token 0, at no cost
            logp = torch.where(finished[:, :, None], frozen, logp)
            scores, idx = top_k((scores[:, :, None] + logp).reshape(
                b, k * v), k)
            parent = idx // v                                 # [B, K]
            tok2 = idx % v
            rows = (base + parent).reshape(-1)
            caches = [tuple(buf.index_select(0, rows) for buf in entry)
                      for entry in caches]
            seqs = seqs.gather(1, parent[..., None].expand_as(seqs))
            fin_p = finished.gather(1, parent)
            seqs[:, :, p + 1 + i] = torch.where(fin_p, 0, tok2)
            finished = fin_p | (tok2 == eos_id) if eos_id is not None \
                else fin_p
            lengths = lengths.gather(1, parent) + (~fin_p).to(torch.float32)
            tok = tok2
        rank = scores / lengths ** length_penalty \
            if length_penalty > 0.0 else scores
        order = torch.argsort(-rank, dim=1, stable=True)
        return (seqs.gather(1, order[..., None].expand_as(seqs)),
                scores.gather(1, order))
